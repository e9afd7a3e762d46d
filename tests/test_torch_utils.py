"""The port's `utils/flops.py`, `utils/tiny.py` and `utils/profiling.py`.

flops: every ported public function returns exactly the JAX package's
number (vits_tpu/utils/flops.py) on the same configuration, walking the
port's modules (built on the meta device, no weights) where the JAX one
walks its dataclasses: at the graft entry's TINY config and at
configs/base.json, with resblock "2" and "1", both training variants, and
the int8 serving split. The decoder's count also equals
`torch.utils.flop_counter.FlopCounterMode`'s count of a TINY decoder
forward, which counts convolutions and matrix products by the same
convention (2 FLOPs a MAC, nothing elementwise); so do the two inference
phases'.

tiny: the port's TINY constructors build the JAX ones' structures: the
training state's parameter trees (keys and shapes through `convert`) and
the TrainStepConfig fields both configs have.

profiling: `trace` writes a trace file on the CPU (the spans and their
reduction: tests/test_torch_tracing.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax

import __graft_entry__
from vits_tpu.config import default_config_path as j_default_config_path
from vits_tpu.config import get_hparams_from_file as j_get_hparams
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.mrd import MultiWaveSTFTDiscriminator as JMRD
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import TrainStepConfig as JStepConfig
from vits_tpu.utils import flops as JF
from vits_tpu.utils import tiny as jtiny

from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu_torch.config import default_config_path, get_hparams_from_file
from vits_tpu_torch.convert import params_to_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator as TMRD
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.optim import Optimizer
from vits_tpu_torch.train.step import TrainStepConfig
from vits_tpu_torch.utils import flops as TF
from vits_tpu_torch.utils import profiling, tiny

SHAPES = ((1, 7, 23), (3, 37, 160))  # (B, T_x, T_y)


def _models(config, resblock):
    """(JAX synth, MPD, MRD, step configs by variant; the port's on the meta
    device) at `config` ("tiny" or "base") with `resblock`."""
    if config == "tiny":
        cfg = dict(__graft_entry__._tiny_cfg(), resblock=resblock)
        j = (JSynth(**cfg), JMPD(periods=(2, 3)), jtiny.tiny_mrd_disc(),
             {v: jtiny.tiny_step_config(v) for v in ("mel", "stft")})
        with torch.device("meta"):
            t = (TSynth(**cfg, weight_norm=True), TMPD(periods=(2, 3)), tiny.tiny_mrd_disc(),
                 {v: tiny.tiny_step_config(v) for v in ("mel", "stft")})
        return j, t
    jh = j_get_hparams(j_default_config_path("base"))
    th = get_hparams_from_file(default_config_path("base"))
    jh.model.resblock = th.model.resblock = resblock
    j = (JSynth.from_hps(jh), JMPD(), JMRD(),
         {v: JStepConfig.from_hps(jh, v) for v in ("mel", "stft")})
    with torch.device("meta"):
        t = (TSynth.from_hps(th, train=True), TMPD(), TMRD(),
             {v: TrainStepConfig.from_hps(th, torch.float32, variant=v) for v in ("mel", "stft")})
    return j, t


def _equal(got, want, what):
    assert type(got) is type(want) or isinstance(got, float), what
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{what}[{i}]")
    else:
        assert got == want, f"{what}: {got} != {want}"


@pytest.mark.parametrize("resblock", ["2", "1"])
@pytest.mark.parametrize("config", ["tiny", "base"])
def test_flops_equal_the_jax_numbers(config, resblock):
    (js, jmpd, jmrd, jcfg), (ts, tmpd, tmrd, tcfg) = _models(config, resblock)
    n = 0
    for B, T_x, T_y in SHAPES:
        cases = {
            "wn_flops": ((js.enc_q._enc(), B, T_y), (ts.enc_q.enc, B, T_y)),
            "attention_encoder_flops": ((js.enc_p._encoder(), B, T_x),
                                        (ts.enc_p.encoder, B, T_x)),
            "text_encoder_flops": ((js.enc_p, B, T_x), (ts.enc_p, B, T_x)),
            "duration_predictor_flops": ((js.dp, B, T_x), (ts.dp, B, T_x)),
            "posterior_encoder_flops": ((js.enc_q, B, T_y), (ts.enc_q, B, T_y)),
            "flow_flops": ((js.flow, B, T_y), (ts.flow, B, T_y)),
            "generator_flops": ((js.dec, B, T_y), (ts.dec, B, T_y)),
            "infer_p1_flops": ((js, B, T_x), (ts, B, T_x)),
            "infer_p2_flops": ((js, B, T_x, T_y), (ts, B, T_x, T_y)),
            "infer_flops": ((js, B, T_x, T_y), (ts, B, T_x, T_y)),
            "infer_q8_split": ((js, B, T_x, T_y), (ts, B, T_x, T_y)),
            "mpd_flops": ((jmpd, B, T_y * 8), (tmpd, B, T_y * 8)),
            "mrd_flops": ((jmrd, B, T_y * 8, jcfg["stft"].resolutions),
                          (tmrd, B, T_y * 8, tmrd.resolutions)),
            "stft_flops": ((B, T_y * 8, 1024, 192, 768), (B, T_y * 8, 1024, 192, 768)),
            "mel_flops": ((B, T_y * 8, 64, 8, 64, 20), (B, T_y * 8, 64, 8, 64, 20)),
        }
        for v in ("mel", "stft"):
            d = (jmpd, tmpd) if v == "mel" else (jmrd, tmrd)
            cases[f"train_step_flops[{v}]"] = ((js, d[0], jcfg[v], B, T_x, T_y),
                                               (ts, d[1], tcfg[v], B, T_x, T_y))
        for name, (jargs, targs) in cases.items():
            fn = name.split("[")[0]
            want, got = getattr(JF, fn)(*jargs), getattr(TF, fn)(*targs)
            _equal(got, want, f"{config} rb{resblock} {name} at {(B, T_x, T_y)}")
            n += 1
    # the primitive walkers on the same layers
    for jl, tl in ((js.dec._resblock(0, 0)._c1(3), ts.dec.resblocks["0"].convs1["1"]),
                   (js.dec._up(0), ts.dec.ups["0"])):
        for T in (5, 64):
            if hasattr(tl, "dilation"):
                assert TF.conv1d_out_len(T, tl) == JF.conv1d_out_len(T, jl)
                assert TF.conv1d_flops(2, T, tl) == JF.conv1d_flops(2, T, jl)
            else:
                assert TF.conv_transpose1d_flops(2, T, tl) == JF.conv_transpose1d_flops(2, T, jl)
    jp = jmpd._discs()[1]._convs()[1]
    tp = tmpd.discriminators["1"].convs["1"]
    assert TF.conv2d_flops(2, 40, 2, tp) == JF.conv2d_flops(2, 40, 2, jp)
    assert TF.dense_flops(3, ts.dec.resblocks["0"].conds["0"]) == \
        JF.dense_flops(3, js.dec._resblock(0, 0)._cond())
    assert n == len(SHAPES) * 17


def test_tiny_mrd_resolutions_are_the_jax_steps():
    assert tiny.TINY_RESOLUTIONS == jtiny.TINY_RESOLUTIONS
    assert tiny.tiny_mrd_disc().resolutions == jtiny.tiny_step_config("stft").resolutions


def _tiny_decoder_inputs(resblock):
    synth = TSynth(**dict(__graft_entry__._tiny_cfg(), resblock=resblock))
    init_weights(synth, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    B, T = 2, 13
    z = torch.randn(B, T, 8, generator=g)
    spk = torch.randn(B, 16, generator=g)
    mask = torch.ones(B, T, 1)
    mask[1, 9:] = 0
    return synth.eval(), z, spk, mask


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn(*args, **kw)
    return counter.get_total_flops()


@pytest.mark.parametrize("resblock", ["2", "1"])
def test_generator_flops_equal_the_flop_counter(one_torch_thread, resblock):  # noqa: F811
    synth, z, spk, mask = _tiny_decoder_inputs(resblock)
    counted = _counted(synth.dec, z, g=spk, x_mask=mask)
    assert TF.generator_flops(synth.dec, *z.shape[:2])["total"] == counted > 0


def test_inference_flops_equal_the_flop_counter(one_torch_thread):  # noqa: F811
    """infer_p1 and infer_p2 counted by FlopCounterMode against
    infer_p1_flops and infer_p2_flops (the attention einsums, the prior
    expansion's two einsums, every conv and dense)."""
    from vits_tpu_torch.ops.seq import infer_path
    synth, _, _, _ = _tiny_decoder_inputs("2")
    g = torch.Generator().manual_seed(2)
    B, T_x, T_y = 2, 9, 30
    x = torch.randn(B, T_x, 16, generator=g)
    emo, sid = torch.randn(B, 1024, generator=g), torch.tensor([1, 5])
    assert _counted(synth.infer_p1, x, emo, sid) == TF.infer_p1_flops(synth, B, T_x)
    m_p, s_p, _, spk = synth.infer_p1(x, emo, sid)
    attn = infer_path(torch.full((B, T_x), float(T_y // T_x)), T_y)
    noise = torch.randn(B, T_y, 8, generator=g)
    assert _counted(synth.infer_p2, attn, m_p, s_p, spk, noise) == \
        TF.infer_p2_flops(synth, B, T_x, T_y)["total"]


@pytest.mark.parametrize("variant", ["mel", "stft"])
def test_tiny_step_config_fields_equal_the_jax_ones(variant):
    t = tiny.tiny_step_config(variant, use_dur_dis=True)
    j = jtiny.tiny_step_config(variant, use_dur_dis=True)
    shared = {f.name for f in dataclasses.fields(t)} & {f.name for f in dataclasses.fields(j)}
    assert shared >= {"variant", "segment_frames", "hop_length", "filter_length",
                      "win_length", "n_mel_channels", "sampling_rate", "use_dur_dis"}
    for name in shared - {"compute_dtype"}:
        assert getattr(t, name) == getattr(j, name), name
    assert t.compute_dtype == torch.float32


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("variant", ["mel", "stft"])
def test_init_gan_state_builds_the_jax_structures(one_torch_thread, variant):  # noqa: F811
    cfg = __graft_entry__._tiny_cfg()
    jdisc = JMPD(periods=(2, 3)) if variant == "mel" else jtiny.tiny_mrd_disc()
    kind = "adamw" if variant == "mel" else "radam"
    jstate = jax.eval_shape(lambda: jtiny.init_gan_state(
        JSynth(**cfg), jdisc, JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01),
        JOptimizer(kind, (0.8, 0.99), 1e-9, 0.0)))
    tdisc = TMPD(periods=(2, 3)) if variant == "mel" else tiny.tiny_mrd_disc()
    state = tiny.init_gan_state(TSynth(**cfg, weight_norm=True), tdisc,
                                Optimizer((0.8, 0.99), 1e-9, 0.01),
                                Optimizer((0.8, 0.99), 1e-9, 0.0, kind), seed=3, device="cpu")
    for key in ("gen", "disc"):
        assert _shapes(params_to_jax(state[key].state_dict())) == \
            _shapes(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), jstate[key])), key
        assert state[key].training
    assert isinstance(state["disc_opt"], torch.optim.RAdam if kind == "radam"
                      else torch.optim.AdamW)
    assert state["step"] == 0 and "dur" not in state
    again = tiny.init_gan_state(TSynth(**cfg, weight_norm=True), tiny.tiny_mrd_disc(),
                                Optimizer((0.8, 0.99), 1e-9, 0.01),
                                Optimizer((0.8, 0.99), 1e-9, 0.0), seed=3, device="cpu")
    for a, b in zip(state["gen"].state_dict().values(), again["gen"].state_dict().values()):
        assert torch.equal(a, b)


def test_trace_writes_a_trace_file(tmp_path, one_torch_thread):  # noqa: F811
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert files, os.listdir(log_dir)
    with open(log_dir / files[0]) as f:
        assert "traceEvents" in json.load(f)
    with profiling.trace(None) as prof:
        pass
    assert prof is None
