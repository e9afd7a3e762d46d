"""The fused serving path's CUDA graphs (`vits_tpu_torch/serve/graphs.py`)
at TINY.

On the CPU nothing is captured: the engine serves today's eager code and
counts no replay and no capture; `HalfGraphs` built on the CPU runs each
half's function on its static inputs, which puts the graph path's wiring
(the static inputs, the unclamped frame count compared with the budget on
the host) through the engine against its eager path, at, under and over a
request's budget; and the pads captured are those the fused pass can reach.

Marked `cuda` (skipping without a CUDA device): the replayed halves equal
the eager ones bit for bit at two text pads and two frame pads, one head
graph gives two requests of its pad their own frame counts, and an engine
with its graphs serves the waveforms of one without them, counting each
replay. Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_graphs.py -q`.
"""

import numpy as np
import pytest
import torch

from benchmark.harness.common import hparams
from benchmark.harness.traffic import hps_of
from benchmark.harness.weights import build_serving_model, write_checkpoint
from benchmark.tests.tiny import TINY_CONFIG
from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.serve.graphs import HalfGraphs

TOKENS = 20  # one 32-token text pad
SEED = 11
GRAPH_COUNTS = ("graph_replays_head", "graph_replays_flow", "graph_captures")


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    hps_dict = hparams(TINY_CONFIG)
    model = build_serving_model(hps_of(hps_dict), SEED, torch.device("cpu"),
                                TINY_CONFIG["assumed"])
    return write_checkpoint(str(tmp_path_factory.mktemp("deploy")), model, hps_dict)


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def _request(n=TOKENS, seed=3):
    rng = np.random.RandomState(seed)
    return 2, rng.randn(n, 16).astype(np.float32), rng.randn(1024).astype(np.float32)


def _head_args(model, spk, text, emo):
    """The head's inputs on the model's device, as the eager fused pass
    builds them."""
    n = len(text)
    x = np.zeros((1, model._quantize(n, model.text_quantum, model.max_text_len),
                  model.text_channels), np.float32)
    x[0, :n] = text
    dt = model.compute_dtype
    return (model._tensor(x, dt), model._tensor([n], torch.int32),
            model._tensor(emo[None], dt), model._tensor([spk], torch.long))


def _frames(model, args, rate):
    return int(model.synth.inference_durations(*args, length_scale=rate,
                                               max_frames=None).y_lengths[0])


def _rate_for(model, args, frames):
    """The least duration rate (to float precision) at which the request
    lasts `frames` frames."""
    lo, hi = 1e-3, 64.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if _frames(model, args, mid) >= frames else (mid, hi)
    assert _frames(model, args, hi) == frames
    return hi


def test_cpu_engine_serves_eagerly(deploy):
    """A CPU engine builds no graphs and counts no replay and no capture,
    over a fused request and a retried one."""
    model = EmoVITS(deploy, device="cpu")
    assert model._graphs is None
    for fpt in ("8", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", fpt)
            np.random.seed(5)
            model.infer(*_request(64, seed=5))
    assert model.counts["requests"] == 2 and model.counts["retried"] == 1
    assert all(model.counts[k] == 0 for k in GRAPH_COUNTS)


@pytest.mark.parametrize("offset", [-1, 0, 1], ids=["under", "at", "over"])
def test_host_budget_check_retries_as_the_clamp_did(deploy, monkeypatch, offset):
    """A request lasting one frame under, exactly, or one frame over a
    budget of two frame quanta, served by an eager engine (the budget clamp
    inside the head) and by one whose head and flows run `HalfGraphs`'s
    entries (the count unclamped, compared with the budget on the host):
    the same retry, the same samples, a replay counted for each half that
    ran."""
    eager = EmoVITS(deploy, device="cpu")
    graphed = EmoVITS(deploy, device="cpu")
    q = eager.frame_quantum
    budget = 2 * q
    spk, text, emo = _request()
    rate = _rate_for(eager, _head_args(eager, spk, text, emo), budget + offset)
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(budget / (TOKENS * rate)))
    assert eager.fused_frames(TOKENS, rate) == budget
    graphed._graphs = HalfGraphs(graphed.synth, "cpu", graphed.compute_dtype,
                                 graphed.text_channels, [32], [q, budget])
    wavs = []
    for model in (eager, graphed):
        np.random.seed(21)
        wavs.append(model.infer(spk, text, emo, duration_rate=rate)[0])
    retried = offset >= 0
    assert eager.counts["retried"] == graphed.counts["retried"] == int(retried)
    np.testing.assert_array_equal(wavs[1], wavs[0])
    assert len(wavs[0]) // eager.hop_size == budget + offset
    assert graphed.counts["graph_replays_head"] == 1
    assert graphed.counts["graph_replays_flow"] == int(not retried)
    assert graphed.counts["fused_frames_served"] == eager.counts["fused_frames_served"]


def test_graph_pads_are_the_reachable_pads(deploy):
    """The text pads are those `_quantize` gives a token count up to
    max_text_len; the frame pads those a count under a budget `fused_frames`
    gives reaches, over every token count and rates up to the ring's cap."""
    model = EmoVITS(deploy, device="cpu")
    tq, fq, mtl = model.text_quantum, model.frame_quantum, model.max_text_len
    text_pads, frame_pads = model.graph_pads()
    assert text_pads == sorted({model._quantize(n, tq, mtl) for n in range(1, mtl + 1)})
    budgets = {model.fused_frames(n, r) for n in range(1, mtl + 1) for r in (0.5, 1.0, 2.0)}
    assert max(budgets) == (model.ring_frames // fq) * fq
    reach = {model._quantize(y, fq) for b in budgets for y in range(1, b)}
    assert frame_pads == sorted(reach)


def test_plain_entries_equal_the_eager_halves(deploy):
    """`HalfGraphs`'s entries on the CPU (its functions on the static
    inputs) equal the eager halves at two text pads and two frame pads, and
    one head entry gives two requests of its pad their own counts."""
    model = EmoVITS(deploy, device="cpu")
    graphs = HalfGraphs(model.synth, "cpu", model.compute_dtype, model.text_channels,
                        [32, 64], [64, 128])
    _check_halves(model, graphs, torch.device("cpu"))


def _check_halves(model, graphs, dev):
    """Each head entry against `inference_durations` unclamped, two
    requests a pad (other token counts and rates: their own frame counts),
    then the flows' entry at each frame pad against `synth.flow` on a
    random latent with the last head's speaker vector; every tensor
    equal."""
    synth = model.synth
    dt = model.compute_dtype
    rng = np.random.RandomState(7)
    with torch.inference_mode():
        counts = []
        for pad, ns in ((32, (20, 9)), (64, (50, 33))):
            for n, rate in zip(ns, (1.0, 1.37)):
                spk, text, emo = _request(n, seed=n)
                args = _head_args(model, spk, text, emo)
                want = synth.inference_durations(*args, length_scale=rate, max_frames=None)
                got = graphs.heads[pad](args[0].cpu(), n, torch.as_tensor(emo[None], dtype=dt),
                                        spk, rate)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
                counts.append(int(got.y_lengths[0]))
            assert counts[-1] != counts[-2]
        g = want.g
        for pad in (64, 128):
            z_p = torch.from_numpy(rng.randn(1, pad, model.inter_channels).astype(np.float32))
            y_mask = torch.zeros(1, pad, 1)
            y_mask[0, :pad - 5] = 1.0
            z_p, y_mask = z_p.to(dev, dt), y_mask.to(dev, dt)
            got = graphs.flow_at(pad)(z_p, y_mask, g=g)
            assert torch.equal(got, synth.flow(z_p, y_mask, g=g))
    assert graphs.flow_at(3 * 64 + 1) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the halves are CUDA graphs)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_halves_equal_the_eager_ones(cuda, deploy):
    """On the card the engine captures every pad `graph_pads` gives; the
    replays equal the eager halves bit for bit at text pads 32 and 64 and
    frame pads 64 and 128, and a head graph gives two requests of its pad
    their own counts."""
    model = EmoVITS(deploy, device=str(cuda))
    text_pads, frame_pads = model.graph_pads()
    assert model.counts["graph_captures"] == len(text_pads) + len(frame_pads)
    assert sorted(model._graphs.heads) == text_pads
    assert sorted(model._graphs.flows) == frame_pads
    _check_halves(model, model._graphs, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_served_waveforms_equal_an_eager_engine(cuda, deploy, monkeypatch, dtype):
    """Requests of several pads, and one whose durations fill its budget,
    served by an engine with its graphs and by one without them on the same
    seeds: the same waveforms; a head replay counted for each fused pass, a
    flows replay for each one not served again, no capture after set-up."""
    graphed = EmoVITS(deploy, device=str(cuda), compute_dtype=dtype)
    eager = EmoVITS(deploy, device=str(cuda), compute_dtype=dtype)
    eager._graphs = None
    captures = graphed.counts["graph_captures"]
    cases = [(n, 8.0) for n in (7, 20, 45, 90, 200)] + [(64, 1.0)]
    for i, (n, fpt) in enumerate(cases):
        monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(fpt))
        spk, text, emo = _request(n, seed=i)
        wavs = []
        for model in (graphed, eager):
            np.random.seed(100 + i)
            wavs.append(model.infer(spk, text, emo, duration_rate=1.0 + 0.1 * i)[0])
        np.testing.assert_array_equal(wavs[0], wavs[1])
    c = graphed.counts
    assert c["retried"] == eager.counts["retried"] == 1
    assert c["graph_replays_head"] == c["requests"] == len(cases)
    assert c["graph_replays_flow"] == len(cases) - 1
    assert c["graph_captures"] == captures
    assert all(eager.counts[k] == 0 for k in GRAPH_COUNTS[:2])
