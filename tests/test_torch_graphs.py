"""The fused serving path's halves (`vits_tpu_torch/serve/graphs.py`) at
TINY.

The engine serves every fused pass through `HalfGraphs`, on every device. On
the CPU nothing is captured: the entries run their functions on their static
inputs, and the engine counts no replay and no capture. Its one path (the
static inputs, the unclamped frame count compared with the budget on the
host) is held to the benchmark's reference of a request at, under and over
its budget; an empty text, whose pad 0 has no entry, fails in the text
encoder; the entries equal the eager halves; and the pads built are those
the fused pass can reach.

Marked `cuda` (skipping without a CUDA device): the replayed halves equal
the eager ones bit for bit at two text pads and two frame pads, one head
graph gives two requests of its pad their own frame counts, and an engine
with its graphs serves the waveforms of one whose `HalfGraphs` captured
nothing, counting each replay. Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_graphs.py -q`."""

import numpy as np
import pytest
import torch

from benchmark.harness.check import fused_budget, ref_request
from benchmark.harness.common import hparams
from benchmark.harness.serve import engine_ring
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
    hps = hps_of(hps_dict)
    model = build_serving_model(hps, SEED, torch.device("cpu"), TINY_CONFIG["assumed"])
    return write_checkpoint(str(tmp_path_factory.mktemp("deploy")), model, hps_dict), hps, model


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


def test_cpu_engine_serves_eagerly(deploy):
    """A CPU engine holds a `HalfGraphs` at every pad `graph_pads` gives,
    none of its entries captured; it serves a fused request and a retried
    one through those entries and counts no replay and no capture."""
    model = EmoVITS(deploy[0], device="cpu")
    graphs = model._graphs
    assert isinstance(graphs, HalfGraphs) and graphs.captures == 0
    assert (sorted(graphs.heads), sorted(graphs.flows)) == model.graph_pads()
    assert all(e.graph is None for e in (*graphs.heads.values(), *graphs.flows.values()))
    for fpt in ("8", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", fpt)
            np.random.seed(5)
            model.infer(*_request(64, seed=5))
    assert model.counts["requests"] == 2 and model.counts["retried"] == 1
    assert model.counts["fused_frames_served"] > 0
    assert all(model.counts[k] == 0 for k in GRAPH_COUNTS)


# (tokens, seed) of a request lasting 127, 128 and 129 frames at rate 1,
# each token's duration at least 0.008 frames from a whole frame
AROUND_TWO_QUANTA = {-1: (22, 38), 0: (22, 7), 1: (24, 11)}


@pytest.mark.parametrize("offset", [-1, 0, 1], ids=["under", "at", "over"])
def test_host_budget_check_retries_as_the_clamp_did(deploy, monkeypatch, offset):
    """A request lasting one frame under, exactly, or one frame over a
    budget of two frame quanta. The engine reads its frame count unclamped
    and compares it with the budget on the host, so it serves the request by
    the fused pass under the budget and again two-phase at and over it, as
    a clamp inside the head did (a count clamped to the budget reaches it
    exactly when the count does). The retry, the frame count and the
    samples are held to the benchmark's reference of the request as the
    engine serves it (`ref_request`)."""
    ckpt, hps, ref = deploy
    model = EmoVITS(ckpt, device="cpu")
    budget = 2 * model.frame_quantum
    n, seed = AROUND_TWO_QUANTA[offset]
    fpt = (budget + 0.5) / n
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(fpt))
    assert model.fused_frames(n) == fused_budget(n, hps, fpt) == budget
    spk, text, emo = _request(n, seed)
    r = {"tokens": n, "text": text, "emo": emo, "spk": spk, "np_seed": 21}
    np.random.seed(r["np_seed"])
    wav, _ = model.infer(spk, text, emo)
    frames = len(wav) // model.hop_size
    retried = offset >= 0
    assert frames == budget + offset
    assert model.counts["retried"] == int(retried)
    assert model.counts["fused_frames_served"] == (0 if retried else frames)
    ref_wav, gap = ref_request(ref, hps, engine_ring(hps), r, frames, fpt,
                               torch.device("cpu"))
    assert gap == 0.0 and len(ref_wav) == len(wav)
    np.testing.assert_allclose(wav, ref_wav, atol=1e-5, rtol=0)


def test_an_empty_text_fails_in_the_text_encoder(deploy):
    """An empty text quantizes to a text pad of 0, which `graph_pads` does
    not give: the fused pass runs the head at that pad, and the text
    encoder's first convolution refuses the empty input. The request is
    counted; no budget, no frame and no decode is."""
    model = EmoVITS(deploy[0], device="cpu")
    spk, _, emo = _request()
    with pytest.raises(RuntimeError, match="Kernel size can't be greater than actual input"):
        model.infer(spk, np.zeros((0, 16), np.float32), emo)
    assert model.counts == {"requests": 1, "retried": 0, "fused_frames_budget": 0,
                            "fused_frames_decoded": 0, "fused_frames_served": 0,
                            "dec_fused": 0, **dict.fromkeys(GRAPH_COUNTS, 0)}


def test_graph_pads_are_the_reachable_pads(deploy):
    """The text pads are those `_quantize` gives a token count up to
    max_text_len; the frame pads those a count under a budget `fused_frames`
    gives reaches, over every token count and rates up to the ring's cap."""
    model = EmoVITS(deploy[0], device="cpu")
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
    model = EmoVITS(deploy[0], device="cpu")
    graphs = HalfGraphs(model.synth, "cpu", model.compute_dtype, model.text_channels,
                        [32, 64], [64, 128], capture=False)
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
            got = graphs.flows[pad](z_p, y_mask, g=g)
            assert torch.equal(got, synth.flow(z_p, y_mask, g=g))
    assert 3 * 64 + 1 not in graphs.flows and 0 not in graphs.heads
    assert graphs.head_at(0).graph is None


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
    model = EmoVITS(deploy[0], device=str(cuda))
    text_pads, frame_pads = model.graph_pads()
    assert model.counts["graph_captures"] == len(text_pads) + len(frame_pads)
    assert sorted(model._graphs.heads) == text_pads
    assert sorted(model._graphs.flows) == frame_pads
    _check_halves(model, model._graphs, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_served_waveforms_equal_an_eager_engine(cuda, deploy, monkeypatch, dtype):
    """Requests of several pads, and one whose durations fill its budget,
    served by an engine with its graphs and by one whose `HalfGraphs`
    captured nothing (its entries run their functions) on the same seeds:
    the same waveforms; a head replay counted for each fused pass, a flows
    replay for each one not served again, no capture after set-up."""
    graphed = EmoVITS(deploy[0], device=str(cuda), compute_dtype=dtype)
    eager = EmoVITS(deploy[0], device=str(cuda), compute_dtype=dtype)
    eager._graphs = HalfGraphs(eager.synth, cuda, eager.compute_dtype, eager.text_channels,
                               *eager.graph_pads(), capture=False)
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
