"""Each driver run end to end on the CPU at TINY sizes, with the program's
plain kernels: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false. The faults are those each cell can
have: an answer altered where it is produced (serving, batch synthesis), a
step that leaves its state unchanged, and half of the batch left out (the
mean taken over the rest)."""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from benchmark.harness import common
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _run(driver: str, seconds: float = 0.5, trace: int = 0, config=None):
    drv = importlib.import_module("benchmark.harness." + tiny.cell(driver)["traffic_file"]
                                  ["driver"])
    result, checks = drv.run(tiny.cell(driver, config), tiny.args(seconds=seconds, trace=trace),
                             common.Clock(), CPU)
    return result, checks


def _correct(checks) -> bool:
    return all(c["ok"] for c in checks)


@pytest.mark.parametrize("driver", ["serve", "batch", "train"])
def test_a_sound_run_is_correct(driver):
    result, checks = _run(driver)
    assert _correct(checks), checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_an_altered_served_answer_is_caught(monkeypatch):
    from vits_tpu_torch.models import synthesizer
    orig = synthesizer.Synthesizer.inference

    def altered(self, *a, **k):
        o, attn, y_mask, rest = orig(self, *a, **k)
        return o * 1.01, attn, y_mask, rest

    monkeypatch.setattr(synthesizer.Synthesizer, "inference", altered)
    _, checks = _run("serve")
    assert not _correct(checks)
    assert next(c for c in checks if c["name"] == "wav_rel_err")["value"] > 1e-3


def test_an_altered_int8_decode_is_caught(monkeypatch):
    from vits_tpu_torch.models import synthesizer
    orig = synthesizer.Generator.forward_q8

    def altered(self, qp, x, g=None, x_mask=None):
        out = orig(self, qp, x, g=g, x_mask=x_mask)
        out[0] = out[0] * 0.99
        return out

    monkeypatch.setattr(synthesizer.Generator, "forward_q8", altered)
    _, checks = _run("batch")
    assert not _correct(checks)


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    from vits_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "update", staticmethod(lambda state, lr: None))
    _, checks = _run("train")
    assert not _correct(checks)
    assert next(c for c in checks if c["name"] == "update_gap")["value"] >= 0.99


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from vits_tpu_torch.train import step
    orig = step.make_train_step

    def halving(cfg, group=None):
        inner = orig(cfg, group)

        def train_step(state, batch, noise, *a, **k):
            half = batch["x"].shape[0] // 2
            return inner(state, {k2: v[:half] for k2, v in batch.items()},
                         {k2: v[:half] for k2, v in noise.items()}, *a, **k)
        return train_step

    monkeypatch.setattr(step, "make_train_step", halving)
    _, checks = _run("train")
    assert not _correct(checks)


@pytest.mark.parametrize("driver", ["serve", "batch", "train"])
def test_the_result_line_has_the_contract_keys(driver, capsys):
    result, checks = _run(driver, trace=0)
    assert common.finish(result, checks) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "setup_s" in line["metrics"]


TRAIN_METRICS = [{"name": n, "unit": "%"} for n in
                 ("k2_roofline.train", "input_stall.train", "mfu.train", "device_idle.train")]


@pytest.mark.parametrize("driver,cell", [("serve", "base-serve-b1"), ("batch", "adapt-batch-q8"),
                                         ("train", None)])
def test_a_traced_run_reads_its_per_layer_metrics(driver, cell):
    with open(common.ROOT + "/BENCHMARK.json") as f:
        spec = json.load(f)
    c = tiny.cell(driver)
    c["per_layer"] = [m for m in spec["per_layer"] if cell in m.get("workloads", [cell])] \
        if cell else TRAIN_METRICS
    drv = importlib.import_module("benchmark.harness." + driver)
    result, checks = drv.run(c, tiny.args(seconds=0.5, trace=1), common.Clock(), CPU)
    assert _correct(checks)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no kernel runs on a card: device shares read 100% idle;
    # device-time rooflines and CUDA-event times find nothing and are left out
    names = set(result["metrics"])
    assert names == {m["name"] for m in c["per_layer"]} - {
        "k1_roofline.synth", "k2_roofline.train", "p1_ms.batch", "p2_ms.batch"}


def test_data_parallel_ranks_equal_the_threaded_reference():
    """Two ranks over gloo, each a process (the driver's own), against the
    reference's two ranks as threads of one process."""
    result, checks = _run("train-ddp", seconds=0.5)
    assert _correct(checks), checks
    assert result["device"]["count"] == 2
