"""The lower-precision controls and a planted fault coming out not correct
at TINY sizes (the reference against the port: test_bench_faults.py). The controls at the cells' own sizes run on the card
(`benchmark/control.py`); the TF32 one needs a card even here."""

from __future__ import annotations

import copy
import os

import pytest
import torch

from benchmark.harness import common
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _bf16_config():
    cfg = copy.deepcopy(tiny.TINY_CONFIG)
    cfg["train"]["bf16_run"] = True
    return cfg


def test_the_int4_control_of_the_batch_cell_is_not_correct():
    import control
    cell = tiny.cell("batch")
    r = control.control_batch(cell, 2 ** 31 + 3, CPU)
    limits = cell["traffic_file"]["check"]["limits"]
    assert not all(r[k] <= limits[k] for k in limits), r


def test_the_fp8_control_of_the_training_cell_is_not_correct():
    import control
    cell = tiny.cell("train", _bf16_config())
    r = control.control_train(cell, 2 ** 31 + 3, CPU, None)
    limits = cell["traffic_file"]["check"]["limits"]
    assert not all(r[k] <= limits[k] for k in limits), r


def test_half_a_batch_in_the_reference_is_not_correct():
    import control
    cell = tiny.cell("train")
    r = control.control_train(cell, 2 ** 31 + 3, CPU, "half_batch")
    limits = cell["traffic_file"]["check"]["limits"]
    assert not all(r[k] <= limits[k] for k in limits), r


@pytest.mark.cuda
def test_the_tf32_control_of_the_serving_cell_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    import control
    cell = tiny.cell("serve")
    r = control.control_serve(cell, 2 ** 31 + 3, torch.device("cuda"))
    limits = cell["traffic_file"]["check"]["limits"]
    assert not all(r[k] <= limits[k] for k in limits), r


@pytest.fixture(autouse=True)
def _control_on_path(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(common.ROOT, "benchmark"))
