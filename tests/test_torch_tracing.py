"""The port's spans and counters on its synthesis path, on the CPU at TINY.

`utils/profiling.span` is the shared no-op while no profiler records. Under
`torch.profiler` the serving engine's paths (fused, two-phase, a fused pass
served again two-phase, streaming) and the batch phases (`infer_p1`,
`infer_p2` with the int8 decoder, at B = 2) open their "vits:" spans in the
nesting the layers have; the waveform is the same bit for bit with the
profiler on and off; `EmoVITS.counts` follows the fused budget's rule
(`benchmark/harness/check.py::fused_budget`, the rule the benchmark reckons
retries by) and counts the frames decoded in whole frame quanta; a
`torch.export` of either serving phase holds no profiler op. A decoder
(ResBlock1 or ResBlock2) opens one span an upsample stage inside its own,
and `scripts/profile_torch_cell.py` gives the decoder's device time
inclusive of its stages'.

`profiling.charge` on kineto-like events: a device operation is charged
through its launch call's correlation id to the innermost span open on the
host when the call began; one without a launch call is unmatched; idle gaps
take the innermost span open when they began.

The deployment is the port's own: `init_weights` from a seeded generator,
the duration predictor's output bias at log 3 (a token lasts ~5 frames).
"""

import importlib.util
import json
import math
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.check import fused_budget
from benchmark.tests.tiny import TINY_CONFIG
from vits_tpu_torch.config import get_hparams_from_file
from vits_tpu_torch.convert import params_to_jax
from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.models.synthesizer import Generator, Synthesizer
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops.seq import infer_path
from vits_tpu_torch.serve.aot import _Phase
from vits_tpu_torch.utils import profiling
from vits_tpu_torch.utils.checkpoint import save_checkpoint

# tokens: with one frame a token budgeted, LONG fills the budget, FEW does not
SHORT, LONG, FEW = 20, 64, 6


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    with open(d / "config.json", "w") as f:
        json.dump({k: TINY_CONFIG[k] for k in ("train", "data", "model")}, f)
    hps = get_hparams_from_file(str(d / "config.json"))
    synth = init_weights(Synthesizer.from_hps(hps), torch.Generator().manual_seed(7))
    with torch.no_grad():
        synth.dp.proj.bias.fill_(math.log(3.0))
    save_checkpoint(str(d / "checkpoint.npz"), {"model": params_to_jax(synth.state_dict())})
    return str(d / "checkpoint.npz"), hps


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def _request(n, seed=3):
    rng = np.random.RandomState(seed)
    return 1, rng.randn(n, 16).astype(np.float32), rng.randn(1024).astype(np.float32)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(prof):
    """The profile's "vits:" spans in start order, each as (depth, name)."""
    evs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.SPAN_PREFIX)),
                 key=lambda e: (e[0], -e[1]))
    out, ends = [], []
    for s, t, name in evs:
        while ends and ends[-1] <= s:
            ends.pop()
        out.append((len(ends), name[len(profiling.SPAN_PREFIX):]))
        ends.append(t)
    return out


DECODERS = ("synth.decoder", "synth.decoder_q8")
STAGES = len(TINY_CONFIG["model"]["upsample_rates"])


def _nest(depth, names, stages=STAGES):
    """(depth, name) for each of `names`, a decoder's upsample stages one
    deeper after it."""
    out = []
    for n in names:
        out.append((depth, n))
        if n in DECODERS:
            out += [(depth + 1, f"{n}.stage{i}") for i in range(stages)]
    return out


MODEL = ["synth.text_encoder", "synth.duration"]
# a CPU engine captures no CUDA graph and replays none
NO_GRAPHS = {"graph_replays_head": 0, "graph_replays_flow": 0, "graph_captures": 0}
# the fused pass up to the read of its frame count, then the rest of it
FUSED_HEAD = _nest(1, ["engine.prep", *MODEL, "synth.align", "engine.durations"])
FUSED = FUSED_HEAD + _nest(1, ["synth.align", "synth.flow", "synth.decoder", "engine.to_host"])
TWO_PHASE = ["engine.prep", *MODEL, "engine.durations", "synth.align", "synth.align",
             "synth.flow", "synth.decoder", "engine.to_host"]


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("synth.flow"), profiling.span("engine.infer", "7")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("synth.flow") is not a


def test_fused_request_spans_and_bit_equal_waveform(deploy):
    model = EmoVITS(deploy[0], device="cpu")
    spk, text, emo = _request(SHORT)
    np.random.seed(11)
    plain, _ = model.infer(spk, text, emo)
    np.random.seed(11)
    (traced, _), prof = _profiled(lambda: model.infer(spk, text, emo))
    np.testing.assert_array_equal(traced, plain)
    assert _tree(prof) == [(0, "engine.infer")] + FUSED


def test_two_phase_request_spans(deploy, monkeypatch):
    monkeypatch.setenv("VITS_TPU_FUSED", "0")
    model = EmoVITS(deploy[0], device="cpu")
    spk, text, emo = _request(SHORT)
    np.random.seed(12)
    plain, _ = model.infer(spk, text, emo)
    np.random.seed(12)
    (traced, _), prof = _profiled(lambda: model.infer(spk, text, emo))
    np.testing.assert_array_equal(traced, plain)
    assert _tree(prof) == [(0, "engine.infer"), (1, "engine.prep")] + _nest(1, TWO_PHASE)


def test_retried_request_spans_and_counts(deploy, monkeypatch):
    """With one frame a token budgeted, a LONG request (~5 frames a token)
    fills its budget and is served again two-phase once its frame count is
    read, decoding nothing first; a FEW-token one fits the 64-frame floor and
    is decoded over its frames in whole quanta. The counters take the
    budgets by the benchmark's rule; both float decodes take the decoder's
    packed body."""
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", "1")
    model = EmoVITS(deploy[0], device="cpu")
    hop, q = model.hop_size, model.frame_quantum
    spk, text, emo = _request(LONG)
    np.random.seed(13)
    (wav, _), prof = _profiled(lambda: model.infer(spk, text, emo))
    assert _tree(prof) == ([(0, "engine.infer")] + FUSED_HEAD + [(1, "engine.retry")]
                           + _nest(2, TWO_PHASE))
    assert model.counts == {"requests": 1, "retried": 1,
                            "fused_frames_budget": fused_budget(LONG, model.hps, 1.0),
                            "fused_frames_decoded": 0, "fused_frames_served": 0,
                            "dec_fused": 1, **NO_GRAPHS}
    assert len(wav) // hop > fused_budget(LONG, model.hps, 1.0)

    spk, text, emo = _request(FEW, seed=4)
    np.random.seed(14)
    wav, _ = model.infer(spk, text, emo)
    frames = len(wav) // hop
    assert 0 < frames < fused_budget(FEW, model.hps, 1.0)
    assert model.counts == {
        "requests": 2, "retried": 1,
        "fused_frames_budget": fused_budget(LONG, model.hps, 1.0) + fused_budget(
            FEW, model.hps, 1.0),
        "fused_frames_decoded": -(-frames // q) * q, "fused_frames_served": frames,
        "dec_fused": 2, **NO_GRAPHS}


def test_stream_spans(deploy):
    model = EmoVITS(deploy[0], device="cpu")
    spk, text, emo = _request(SHORT)
    np.random.seed(15)
    chunks, prof = _profiled(lambda: list(model.infer_stream(spk, text, emo, chunk_frames=32)))
    assert len(chunks) >= 2
    head = ["engine.prep", "engine.prep", *MODEL, "engine.durations", "synth.align",
            "synth.align", "synth.flow"]
    assert _tree(prof) == _nest(0, head + ["synth.decoder", "engine.to_host"] * len(chunks))
    assert model.counts["requests"] == 1 and model.counts["retried"] == 0


def test_batch_phases_spans(deploy):
    model = EmoVITS(deploy[0], device="cpu")
    synth, C = model.synth, model.inter_channels
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 32, 16).astype(np.float32))
    x_mask = torch.ones(2, 32, 1)
    x_mask[1, 20:] = 0
    emo = torch.from_numpy(rng.randn(2, 1024).astype(np.float32))
    sid = torch.tensor([1, 6])
    m_p, s_p, logw, g = synth.infer_p1(x, emo, sid, x_mask=x_mask)
    dur = torch.ceil(torch.exp(logw[..., 0])) * x_mask[..., 0]
    attn = infer_path(dur, 128)
    noise = torch.from_numpy(rng.randn(2, 128, C).astype(np.float32))
    y_mask = (torch.arange(128)[None] < dur.sum(1, keepdim=True)).float()[..., None]
    dec_q8 = synth.quantize_decoder(synth.latent(attn, m_p, s_p, g, noise, y_mask), g, y_mask)
    plain = synth.infer_p2(attn, m_p, s_p, g, noise, y_mask, dec_q8=dec_q8)

    def run():
        synth.infer_p1(x, emo, sid, x_mask=x_mask)
        return synth.infer_p2(attn, m_p, s_p, g, noise, y_mask, dec_q8=dec_q8)
    traced, prof = _profiled(run)
    assert torch.equal(traced, plain)
    assert _tree(prof) == _nest(0, [*MODEL, "synth.align", "synth.flow", "synth.decoder_q8"])


@pytest.mark.parametrize("phase", [1, 2])
def test_exported_phase_holds_no_profiler_op(deploy, phase):
    model = EmoVITS(deploy[0], device="cpu")
    hps, synth = model.hps, model.synth
    params = dict(sorted(synth.state_dict().items()))
    z = torch.zeros
    T, F, C = 32, 64, hps.model.inter_channels
    args = ((params, z(1, T, 16), z(1, T, 1), z(1, 1024), z(1, dtype=torch.long)) if phase == 1
            else (params, z(1, F, T), z(1, T, C), z(1, T, C), z(1, hps.model.gin_channels),
                  z(1, F, C), z(1, F, 1)))
    with torch.no_grad():
        ep = torch.export.export(_Phase(synth, phase), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def _profile_cell_script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "profile_torch_cell.py")
    spec = importlib.util.spec_from_file_location("profile_torch_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launched(prof):
    """The capture's spans, with a 1 us device operation launched at the
    start of each of its torch ops (a CPU capture has no device timeline)."""
    evs = []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if name.startswith(profiling.SPAN_PREFIX):
            evs.append(types.SimpleNamespace(
                name=lambda n=name: n, start_ns=lambda s=start: s, duration_ns=lambda d=dur: d,
                correlation_id=lambda: 0, start_thread_id=lambda: 1,
                device_type=lambda: "DeviceType.CPU"))
        elif name.startswith("aten::"):
            k = len(evs) + 1
            evs.append(types.SimpleNamespace(
                name=lambda: "cudaLaunchKernel", start_ns=lambda s=start: s,
                duration_ns=lambda: 1, correlation_id=lambda k=k: k, start_thread_id=lambda: 1,
                device_type=lambda: "DeviceType.CPU"))
            evs.append(types.SimpleNamespace(
                name=lambda k=k: f"op{k}", start_ns=lambda k=k: 2 * 10 ** 12 + 2000 * k,
                duration_ns=lambda: 1000, correlation_id=lambda k=k: k,
                start_thread_id=lambda: 0, device_type=lambda: "DeviceType.CUDA"))
    return evs


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_decoder_stage_spans_make_up_the_decoder(resblock):
    """A decoder of four upsample stages (the VCTK configuration's pattern at
    TINY widths), ResBlock1 or ResBlock2: each call opens one span a stage
    inside "synth.decoder". With a 1 us operation launched at each torch op
    of the capture, `scripts/profile_torch_cell.py`'s inclusive decoder time
    is the decoder's own time plus its stages', which is all that was
    launched inside the decoder."""
    dec = init_weights(Generator(8, resblock, [3], [[1, 3]], [8, 8, 2, 2], 256, [16, 16, 4, 4],
                                 gin_channels=16), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x, g = torch.randn(1, 4, 8, generator=gen), torch.randn(1, 16, generator=gen)
    with torch.no_grad():
        _, prof = _profiled(lambda: [dec(x, g=g, x_mask=torch.ones(1, 4, 1)) for _ in range(2)])
    assert _tree(prof) == _nest(0, ["synth.decoder"] * 2, stages=4)

    evs = _launched(prof)
    charged = profiling.charge(evs)
    inclusive, stages = _profile_cell_script().decoder_ms(charged)
    assert sorted(stages) == [f"synth.decoder.stage{i}" for i in range(4)]
    assert all(v > 0 for v in stages.values())
    own = 1e3 * charged["span_device_s"]["synth.decoder"] / 2
    assert inclusive == pytest.approx(own + sum(stages.values()), rel=1e-12)
    decoders = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                if e.name() == "vits:synth.decoder"]
    inside = sum(1 for e in evs if e.name() == "cudaLaunchKernel"
                 and any(a <= e.start_ns() <= b for a, b in decoders))
    assert inclusive == pytest.approx(1e-3 * inside / 2, rel=1e-12)


# ---------------------------------------------------------------------------
# profiling.charge on kineto-like events
# ---------------------------------------------------------------------------

def _ev(name, start_us, dur_us, device=False, corr=0, tid=1):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(start_us * 1000),
        duration_ns=lambda: int(dur_us * 1000), correlation_id=lambda: corr,
        start_thread_id=lambda: tid,
        device_type=lambda: "DeviceType.CUDA" if device else "DeviceType.CPU")


def _capture():
    """A request span [0, 100) holding a decoder span [10, 60); launches at
    5 (outside the decoder), 20 and 30 (inside), a copy at 70; a kernel
    whose launch is missing; the decoder's twin on the device's timeline."""
    return [
        _ev("vits:engine.infer", 0, 100), _ev("vits:synth.decoder", 10, 50),
        _ev("aten::conv1d", 19, 3, corr=21),  # a torch op: its id is not a launch's
        _ev("cudaLaunchKernel", 5, 1, corr=21), _ev("conv_kernel", 40, 10, True, corr=21),
        _ev("cuLaunchKernel", 20, 1, corr=22), _ev("triton_kernel", 50, 20, True, corr=22),
        _ev("cudaLaunchKernel", 30, 1, corr=23), _ev("rb2_chain_kernel", 75, 5, True, corr=23),
        _ev("cudaMemcpyAsync", 70, 2, corr=24), _ev("Memcpy DtoH", 90, 4, True, corr=24),
        _ev("cudaStreamSynchronize", 72, 25, corr=25),
        _ev("orphan_kernel", 120, 2, True, corr=99),
        _ev("vits:synth.decoder", 40, 25, True, corr=0),
    ]


def test_charge_through_the_launch_correlation_id():
    r = profiling.charge(_capture())
    assert r["span_calls"] == {"engine.infer": 1, "synth.decoder": 1}
    # conv_kernel runs inside the decoder's host span but was launched
    # before it opened: it is the request's
    assert r["span_device_s"] == pytest.approx({"engine.infer": (10 + 4) * 1e-6,
                                                "synth.decoder": (20 + 5) * 1e-6})
    assert r["launch_calls"] == {"cudaLaunchKernel": 2, "cuLaunchKernel": 1,
                                 "cudaMemcpyAsync": 1}
    assert r["unspanned_device_s"] == 0.0


def test_charge_counts_a_kernel_without_a_launch_as_unmatched():
    r = profiling.charge(_capture())
    assert r["unmatched_device_s"] == pytest.approx(2e-6)
    assert list(r["unmatched_ops"]) == ["orphan_kernel"]
    # busy: [40, 70), [75, 80), [90, 94), [120, 122); the twin is no op
    assert r["busy_s"] == pytest.approx((30 + 5 + 4 + 2) * 1e-6)


def test_charge_labels_idle_gaps_by_the_innermost_span():
    r = profiling.charge(_capture())
    # the gaps [70, 75), [80, 90) and [94, 120) begin inside the request
    # (the decoder closed at 60); nothing before the first operation is a gap
    assert r["idle_s"] == pytest.approx({"engine.infer": (5 + 10 + 26) * 1e-6})
    later = _capture() + [_ev("vits:synth.flow", 78, 5), _ev("cudaLaunchKernel", 130, 1, corr=30),
                          _ev("k_late", 130, 1, True, corr=30)]
    r = profiling.charge(later)
    assert r["idle_s"] == pytest.approx({"synth.flow": 10e-6, "engine.infer": 31e-6,
                                         "outside spans": 8e-6})
    assert r["unspanned_device_s"] == pytest.approx(1e-6)


def test_charge_across_threads_and_other_prefixes():
    """A launch from a thread with no span open (the autograd engine's
    worker in a backward pass) goes to the span open on another; the
    training profile's own ranges ("layer:") charge beside the program's."""
    evs = [_ev("vits:synth.decoder", 0, 50, tid=1), _ev("cudaLaunchKernel", 10, 1, corr=5, tid=7),
           _ev("k", 20, 5, True, corr=5), _ev("layer:MPD", 60, 40, tid=1),
           _ev("cudaLaunchKernel", 70, 1, corr=6, tid=1), _ev("k2", 80, 5, True, corr=6)]
    r = profiling.charge(evs)
    assert r["span_device_s"] == pytest.approx({"synth.decoder": 5e-6})
    assert r["unspanned_device_s"] == pytest.approx(5e-6)
    r = profiling.charge(evs, prefixes=("vits:", "layer:"))
    assert r["span_device_s"] == pytest.approx({"synth.decoder": 5e-6, "MPD": 5e-6})
    assert r["span_calls"] == {"synth.decoder": 1, "MPD": 1}
