"""The fused serving path decodes only the frames a request needs, on the
CPU at TINY.

`EmoVITS.infer_fused` runs `Synthesizer.inference` in its two halves: the
text encoder, the durations and the frame count F on the device
(`inference_durations`), F read back to the host, then the alignment, the
flows and the decoder over F in whole frame quanta (`inference_decode`), the
prior noise the first frames of the slice drawn for the budget. Every layer
masks the frames past F, so the served samples are those of the one pass over
the whole budget, up to the order of float sums: checked in fp32 and bf16 at
a count in whole quanta and at one frame short of the budget. A request
whose durations fill the budget is served again two-phase with the same two
host draws as before; both paths are held to the benchmark's own reference
(`benchmark/harness/check.py::ref_request`). The two halves composed at a
budget are the one pass bit for bit (a copy of the pass as one body here).

The deployment is the benchmark's TINY configuration with its seeded
weights (about 3 frames a token), so the reference has the engine's weights.

The float decoder's packed body (`Generator.pack_fused`: bias-free convs on
(B, C, T), ResBlock1's conv1 narrowed to the channels conv2 reads, the glue
kernels' plain twins here) equals the eager body through `forward`,
`infer_p2` and `inference_decode` for both resblock types, with a prefix
mask and without; an fp32 engine takes it for every float decode and counts
each (`dec_fused`); a bf16 engine, autograd, a calibration record, a
tensor-parallel decoder and a torch.export trace keep the eager body.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness.check import fused_budget, ref_request, rel_err
from benchmark.harness.common import hparams
from benchmark.harness.serve import engine_ring
from benchmark.harness.traffic import hps_of
from benchmark.harness.weights import build_serving_model, write_checkpoint
from benchmark.tests.tiny import TINY_CONFIG
from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.models.synthesizer import Generator, Synthesizer
from vits_tpu_torch.nn import dec_glue
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops.seq import generate_path, infer_path, sequence_mask
from vits_tpu_torch.parallel.mesh import Mesh, TPDecoder

TOKENS = 20  # one 32-token text bucket
SEED = 11


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    hps_dict = hparams(TINY_CONFIG)
    hps = hps_of(hps_dict)
    model = build_serving_model(hps, SEED, torch.device("cpu"), TINY_CONFIG["assumed"])
    return write_checkpoint(str(tmp_path_factory.mktemp("deploy")), model, hps_dict), hps


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def _request(n=TOKENS, seed=3):
    rng = np.random.RandomState(seed)
    return 2, rng.randn(n, 16).astype(np.float32), rng.randn(1024).astype(np.float32)


def _args(model, spk, text, emo):
    """The first half's inputs as `infer_fused` builds them."""
    n = len(text)
    x = np.zeros((1, model._quantize(n, model.text_quantum, model.max_text_len),
                  model.text_channels), np.float32)
    x[0, :n] = text
    dt = model.compute_dtype
    return (model._tensor(x, dt), model._tensor([n], torch.int32),
            model._tensor(emo[None], dt), model._tensor([spk], torch.long))


def _rate_for(model, args, frames):
    """The least duration rate (to float precision) at which the request
    lasts `frames` frames."""
    def count(rate):
        return int(model.synth.inference_durations(*args, length_scale=rate,
                                                   max_frames=10 ** 6).y_lengths[0])
    lo, hi = 1e-3, 64.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if count(mid) >= frames else (mid, hi)
    assert count(hi) == frames
    return hi


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["whole_quanta", "budget_less_one"])
def test_served_samples_equal_the_pass_over_the_budget(deploy, monkeypatch, dtype, case):
    """The served waveform against `Synthesizer.inference` over the budget
    with the same noise slice, on the served samples: a frame count of two
    whole quanta (decoded without a padded frame) and one a frame short of
    its budget (decoded over the whole budget). fp32 within 1e-5; bf16
    within 2e-3, two bf16 steps at the waveform's peak (~0.15), room for its
    sums rounded in another order."""
    model = EmoVITS(deploy[0], device="cpu", compute_dtype=dtype)
    q, hop, C = model.frame_quantum, model.hop_size, model.inter_channels
    spk, text, emo = _request()
    args = _args(model, spk, text, emo)
    frames = 2 * q if case == "whole_quanta" else 2 * q - 1
    rate = _rate_for(model, args, frames)
    if case == "budget_less_one":  # a budget of two quanta at this rate
        monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(2 * q / (TOKENS * rate)))
    budget = model.fused_frames(TOKENS, rate)
    assert budget > frames and (case == "whole_quanta" or budget == frames + 1)

    np.random.seed(21)
    wav, _ = model.infer_fused(spk, text, emo, duration_rate=rate)
    np.random.seed(21)
    start = np.random.randint(max(model.noise.size - budget * C, 1))
    noise = model._noise_dev[start:start + budget * C].reshape(1, budget, C)
    o = model.synth.inference(*args, length_scale=rate, max_frames=budget, noise=noise)[0]
    ref = o[0, :frames * hop, 0].float().numpy()

    assert len(wav) == frames * hop
    np.testing.assert_allclose(wav, ref, atol=1e-5 if dtype == "fp32" else 2e-3, rtol=0)
    assert model.counts["fused_frames_budget"] == budget
    assert model.counts["fused_frames_decoded"] == 2 * q
    assert model.counts["fused_frames_served"] == frames


@pytest.mark.parametrize("frames_per_token", [8.0, 1.0], ids=["fused", "retried"])
def test_served_request_equals_the_benchmark_reference(deploy, monkeypatch, frames_per_token):
    """A request served by the fused pass, and one whose durations fill a
    budget of one frame a token and which is served again two-phase with the
    engine's second draw, each against the benchmark's reference of the
    request as the engine serves it: the same durations and waveform."""
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(frames_per_token))
    ckpt, hps = deploy
    model = EmoVITS(ckpt, device="cpu")
    hop = model.hop_size
    spk, text, emo = _request(64, seed=5)
    r = {"tokens": 64, "text": text, "emo": emo, "spk": spk, "np_seed": 1234}
    np.random.seed(r["np_seed"])
    wav, _ = model.infer(spk, text, emo)
    frames = len(wav) // hop
    retried = frames >= fused_budget(64, hps, frames_per_token)
    assert model.counts["retried"] == int(retried) == int(frames_per_token == 1.0)
    if retried:
        assert model.counts["fused_frames_decoded"] == 0

    ref = build_serving_model(hps, SEED, torch.device("cpu"), TINY_CONFIG["assumed"])
    ref_wav, gap = ref_request(ref, hps, engine_ring(hps), r, frames, frames_per_token,
                               torch.device("cpu"))
    assert gap == 0.0 and len(ref_wav) == len(wav)
    np.testing.assert_allclose(wav, ref_wav, atol=1e-5, rtol=0)
    assert rel_err(wav, ref_wav) < 1e-5


def _one_pass(synth, x, x_lengths, emo, sid, noise_scale=1.0, length_scale=1.0,
              max_frames=1000, noise=None, generator=None):
    """`Synthesizer.inference` as one body, for the float decoder."""
    g = synth.emb_g(sid)
    x_mask = sequence_mask(x_lengths, x.shape[1])[..., None].to(x.dtype)
    x_h, m_p, logs_p = synth.enc_p(x, x_mask, emo=emo, g=g)
    logw = synth.dp(x_h, x_mask, g=g)
    w_ceil = torch.ceil((torch.exp(logw) * x_mask).float() * length_scale)[..., 0]
    y_lengths = torch.sum(w_ceil, dim=-1).clamp(min=1.0).to(torch.int32)
    y_lengths = y_lengths.clamp(max=max_frames)
    y_mask = sequence_mask(y_lengths, max_frames)[..., None].to(x.dtype)
    attn = generate_path(w_ceil, y_mask * x_mask.transpose(1, 2)).to(x.dtype)
    m_p_e = torch.einsum("byx,bxc->byc", attn, m_p)
    logs_p_e = torch.einsum("byx,bxc->byc", attn, logs_p)
    if noise is None:
        noise = torch.randn(m_p_e.shape, generator=generator, device=m_p_e.device,
                            dtype=m_p_e.dtype) * noise_scale
    z_p = m_p_e + noise.to(m_p_e.dtype) * torch.exp(logs_p_e)
    z = synth.flow(z_p, y_mask, g=g)
    o = synth.dec(z * y_mask, g=g, x_mask=y_mask)
    return o, attn, y_mask, (z, z_p, m_p_e, logs_p_e)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_the_halves_composed_are_the_one_pass(deploy, dtype):
    """At B = 2 with ragged text and a budget that clips the first
    utterance, with noise given and drawn from a generator: every output of
    `inference` equals the one pass bit for bit."""
    synth = EmoVITS(deploy[0], device="cpu", compute_dtype=dtype).synth
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randn(2, 32, 16).astype(np.float32)).to(dt)
    x_len = torch.tensor([TOKENS, 2], dtype=torch.int32)
    emo = torch.from_numpy(rng.randn(2, 1024).astype(np.float32)).to(dt)
    sid = torch.tensor([1, 6])
    max_frames = 32
    noise = torch.from_numpy(rng.randn(2, max_frames, 8).astype(np.float32))
    with torch.no_grad():
        for kw in ({"noise": noise}, {"noise_scale": 0.7}):
            outs = []
            for fn in (synth.inference, lambda *a, **k: _one_pass(synth, *a, **k)):
                gen = torch.Generator().manual_seed(5)
                outs.append(fn(x, x_len, emo, sid, length_scale=0.9, max_frames=max_frames,
                               generator=gen, **kw))
            (o, attn, ym, lat), (o1, attn1, ym1, lat1) = outs
            lengths = ym[..., 0].sum(1)
            assert lengths[0] == max_frames > lengths[1] > 0
            for a, b in zip((o, attn, ym, *lat), (o1, attn1, ym1, *lat1)):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the float decoder's packed body (`Generator.pack_fused`) and who takes it
# ---------------------------------------------------------------------------

def _synth(resblock):
    """TINY's synthesizer with three resblocks a stage (kernels 3, 5, 7 at
    dilations 1, 3, 5: their running sum and mean), seeded weights."""
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["model"].update(resblock=resblock, resblock_kernel_sizes=[3, 5, 7],
                        resblock_dilation_sizes=[[1, 3, 5]] * 3)
    synth = Synthesizer.from_hps(hps_of(hparams(cfg)))
    return init_weights(synth, torch.Generator().manual_seed(7)).eval()


def _decode_both(synth, caller, mask):
    """(packed, eager) outputs of one float decode at B = 2 through `caller`,
    of `synth` with its decoder's pack kept and of a copy without one;
    mask "prefix": the second utterance valid for 21 of 40 frames, "none":
    no mask (inference_decode, which always masks: every frame valid)."""
    rng = np.random.RandomState(13)
    B, T, C = 2, 40, synth.inter_channels
    valid = [T, 21] if mask == "prefix" else [T, T]
    y_mask = sequence_mask(torch.tensor(valid), T)[..., None].float()
    g = synth.emb_g(torch.tensor([1, 5]))
    eager = copy.deepcopy(synth)  # keeps no pack
    assert synth.dec.pack_fused() is not None
    synths = (synth, eager)
    with torch.no_grad():
        if caller == "forward":
            z = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)) * y_mask
            m = y_mask if mask == "prefix" else None
            outs = [s.dec(z, g=g, x_mask=m) for s in synths]
        elif caller == "infer_p2":
            x = torch.from_numpy(rng.randn(B, 12, 16).astype(np.float32))
            emo = torch.from_numpy(rng.randn(B, 1024).astype(np.float32))
            m_p, s_p, _, g = synth.infer_p1(x, emo, torch.tensor([1, 5]))
            attn = infer_path(torch.full((B, 12), T / 12.0).ceil(), T)[:, :T]
            noise = torch.from_numpy(rng.randn(B, T, C).astype(np.float32))
            m = y_mask if mask == "prefix" else None
            outs = [s.infer_p2(attn, m_p, s_p, g, noise, m) for s in synths]
        else:
            x = torch.from_numpy(rng.randn(B, 12, 16).astype(np.float32))
            emo = torch.from_numpy(rng.randn(B, 1024).astype(np.float32))
            head = synth.inference_durations(x, torch.tensor([12, 9]), emo, torch.tensor([1, 5]),
                                             max_frames=None)
            frames = int(head.y_lengths.max()) + (8 if mask == "prefix" else 0)
            if mask == "none":  # every frame of both utterances valid
                head = head._replace(y_lengths=torch.full_like(head.y_lengths, frames))
            noise = torch.from_numpy(rng.randn(B, frames, C).astype(np.float32))
            outs = [s.inference_decode(head, frames, noise=noise)[0] for s in synths]
    assert (synth.dec.fused_decodes, eager.dec.fused_decodes) == (1, 0)
    return outs


@pytest.mark.parametrize("caller", ["forward", "infer_p2", "inference_decode"])
@pytest.mark.parametrize("mask", ["prefix", "none"])
@pytest.mark.parametrize("resblock", ["2", "1"])
def test_packed_decode_equals_the_eager_body(resblock, mask, caller):
    """The packed body (bias-free convs in (B, C, T), ResBlock1's conv1
    narrowed, the glue kernels' plain twins) against the eager body, fp32,
    within 1e-6 (float order: the biases and speaker terms summed first)."""
    packed, eager = _decode_both(_synth(resblock), caller, mask)
    assert packed.shape == eager.shape and packed.dtype == torch.float32
    np.testing.assert_allclose(packed.numpy(), eager.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("how", ["deepcopy", "to"])
def test_a_copied_or_moved_decoder_builds_its_pack_again(how, monkeypatch):
    """After `copy.deepcopy` or `.to()` (a float64 round trip) the kept
    pack's kernels are views of the decoder's own new weights: an in-place
    edit of one moves the packed decode as it moves the eager one."""
    synth = _synth("1")
    synth.dec.pack_fused()
    dec = copy.deepcopy(synth.dec) if how == "deepcopy" else synth.dec.double().float()
    z, g = torch.randn(2, 16, synth.inter_channels), synth.emb_g(torch.tensor([1, 5])).detach()
    with torch.no_grad():
        dec.resblocks["1"].convs1["2"].weight.mul_(1.5)
        packed = dec(z, g=g)
        monkeypatch.setattr(dec, "_pack", None)
        eager = dec(z, g=g)
    assert dec.fused_decodes == 1
    np.testing.assert_allclose(packed.numpy(), eager.numpy(), atol=1e-6, rtol=0)


@pytest.fixture
def no_packed_body(monkeypatch):
    """The packed body made to fail: what runs still serves the eager one."""
    def refuse(*a, **k):
        raise AssertionError("the packed body ran")
    monkeypatch.setattr(Generator, "_forward_fused", refuse)


@pytest.mark.parametrize("caller", ["bf16_engine", "grad", "record", "tp_decoder", "export"])
def test_other_callers_take_the_eager_body(deploy, no_packed_body, caller):
    """With the decoder's pack kept, a bf16 engine counts no packed decode;
    a forward with grad on, a calibration record, a tensor-parallel
    decoder's sharded layers (the pack built again: none) and a torch.export
    trace (the dispatch rule alone) keep the eager body."""
    synth = _synth("2")
    dec = synth.dec
    assert dec.pack_fused() is not None
    z, g = torch.randn(1, 8, synth.inter_channels), synth.emb_g(torch.tensor([3]))
    if caller == "bf16_engine":
        model = EmoVITS(deploy[0], device="cpu", compute_dtype="bf16")
        spk, text, emo = _request()
        model.infer(spk, text, emo)
        assert model.counts["dec_fused"] == model.synth.dec.fused_decodes == 0
    elif caller == "grad":
        with torch.enable_grad():
            assert not dec.takes_fused(z, g)
            assert dec(z, g=g.detach()).requires_grad
    elif caller == "record":
        record = {}
        with torch.no_grad():
            dec(z, g=g, record=record)
        assert "post_in" in record
    elif caller == "tp_decoder":
        tp = TPDecoder(dec, Mesh(1, 2, 0, torch.device("cpu"), None), min_channels=8)
        with torch.no_grad():
            assert tp.sharded and dec.takes_fused(z, g) and not tp.gen.takes_fused(z, g)
    else:
        seen = []

        class Probe(torch.nn.Module):
            def forward(self, x, g):
                seen.append(dec.takes_fused(x, g))
                return x + 1

        g = g.detach()
        with torch.no_grad():
            assert dec.takes_fused(z, g)
            torch.export.export(Probe(), (z, g), strict=False)
        assert seen == [False]
    assert dec.fused_decodes == 0


@pytest.mark.parametrize("path", ["fused", "retried", "streamed"])
def test_an_fp32_engine_decodes_through_the_pack(deploy, path, monkeypatch):
    """Every float decode of an fp32 engine takes the packed body, the
    fused pass, the two-phase retry and each streamed window alike:
    `dec_fused` reads the decoder's count of the packed body's runs, and
    the glue's plain twins ran (no kernel launch on the CPU)."""
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", "1.0" if path == "retried" else "8.0")
    model = EmoVITS(deploy[0], device="cpu")
    dec = model.synth.dec
    calls = []
    real = Generator._forward_fused
    monkeypatch.setattr(Generator, "_forward_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = dec_glue.counter.launches
    spk, text, emo = _request(64, seed=5)
    for i in range(2):
        if path == "streamed":
            chunks = list(model.infer_stream(spk, text, emo))
        else:
            model.infer(spk, text, emo)
    assert model.counts["retried"] == (2 if path == "retried" else 0)
    n = 2 * len(chunks) if path == "streamed" else 2
    assert model.counts["dec_fused"] == dec.fused_decodes == len(calls) == n
    assert dec_glue.counter.launches == launches
