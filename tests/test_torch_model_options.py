"""The model options the shipped configs do not use, against the JAX package
at TINY on the CPU in fp32: ResBlock1 (`resblock: "1"`), the learned Swish
of the duration predictor (`act_func_d: "swish"`), ElementwiseAffine, the
Log flow, the affine coupling's logdet, `istft`; the leaves they add
carried through `.npz` and `.pth`; the int8 refusal on a ResBlock1 decoder;
and the text encoder's position table, built once.

Weights: the port's seeded initialisation carried to JAX trees by
`params_to_jax` (Swish's scalars moved off 1). Tolerances, those of
tests/test_torch_train.py: forward outputs atol 1e-4 rtol 1e-4 (a block
alone atol 1e-5); the step's losses rtol 1e-4 atol 1e-6, every gradient
atol 1e-5 + 1e-3 of the tensor's largest magnitude, updated parameters
atol 1e-6 + 1e-4 relative plus 2 * lr where a gradient element lies within
its tolerance of zero; the MAS path equal. The flows and istft: atol 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_istft
from test_torch_dur_disc import HIDDEN, LOSS_KEYS, LR_P, P_KEYS, _cfg_t
from test_torch_train import (FAST_COMPILE, LR, _batch, _cfg, _noise, _np, _Probe,  # noqa: F401
                              _torch_batch, one_torch_thread)
from vits_tpu.models import modules as JM
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import DurationDiscriminator as JDur
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.ops import stft as JS
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils.tiny import tiny_step_config
from vits_tpu.utils.torch_compat import load_torch_checkpoint as j_load_torch_checkpoint

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models import modules as TM
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import DurationDiscriminator as TDur
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.models.synthesizer import TextEncoder
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops import stft as TS
from vits_tpu_torch.ops.seq import gen_sin_table
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import make_train_step
from vits_tpu_torch.utils import checkpoint as tck
from vits_tpu_torch.utils.torch_compat import load_torch_checkpoint, save_torch_checkpoint, \
    tree_template

KEY = 21
SWISH = (0.7, 1.3)  # act_1's and act_2's scalars


def options_cfg():
    """The TINY synthesizer with both options: ResBlock1 decoders (two
    kernels) and the learned Swish in the duration predictor."""
    cfg = _cfg()
    cfg.update(resblock="1", act_func_d="swish", resblock_kernel_sizes=(3, 5),
               resblock_dilation_sizes=((1, 3), (1, 3, 5)))
    return cfg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(5)
    synth = init_weights(TSynth(**options_cfg(), weight_norm=True), gen)
    with torch.no_grad():
        synth.dp.act_1.weight.fill_(SWISH[0])
        synth.dp.act_2.weight.fill_(SWISH[1])
    models = (synth, init_weights(TMPD(periods=(2, 3)), gen),
              init_weights(TDur(HIDDEN, 64, 5), gen))
    return tuple(params_to_jax(m.state_dict()) for m in models)


def _mask(B, T, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_resblock1_forward_and_gradients_match_jax(masked):
    C, k, dil, gin, B, T = 32, 5, (1, 3, 5), 16, 2, 20
    tb = init_weights(TM.ResBlock1(C, k, dil, gin, weight_norm=True),
                      torch.Generator().manual_seed(1))
    assert tb.inter_channels == 32 and tb.convs1["0"].out_channels == 64
    p = params_to_jax(tb.state_dict())
    rng = np.random.RandomState(2)
    x, g, r = (rng.randn(*s).astype(np.float32) for s in ((B, T, C), (B, gin), (B, T, C)))
    m = _mask(B, T, (T, T - 7)) if masked else None
    jb = JM.ResBlock1(C, k, dil, gin)

    def loss_j(p):
        y = jb.apply(p, jnp.asarray(x), jnp.asarray(g), None if m is None else jnp.asarray(m))
        return jnp.sum(y * r), y
    (_, y_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(p)
    y_t = tb(_t(x), _t(g), None if m is None else _t(m))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-4)
    torch.sum(y_t * _t(r)).backward()
    grads = state_from_jax(_np(g_j), set(tb.state_dict()))
    for name, prm in tb.named_parameters():
        want = grads[name].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0,
                                   atol=1e-5 + 1e-3 * float(np.abs(want).max()), err_msg=name)


def test_resblock1_generator_forward_and_gradients_match_jax(weights):
    gp = weights[0]
    ts = params_from_jax(gp, TSynth(**options_cfg(), weight_norm=True))
    assert all(isinstance(rb, TM.ResBlock1) for rb in ts.dec.resblocks.values())
    dec_j = JSynth(**options_cfg()).dec
    B, T, C, gin = 2, 12, _cfg()["inter_channels"], _cfg()["gin_channels"]
    rng = np.random.RandomState(3)
    z, g = rng.randn(B, T, C).astype(np.float32), rng.randn(B, gin).astype(np.float32)
    m = _mask(B, T, (T, T - 5))
    r = rng.randn(B, T * 8, 1).astype(np.float32)

    def loss_j(p):
        o = dec_j.apply(p, jnp.asarray(z), g=jnp.asarray(g), x_mask=jnp.asarray(m), packed=False)
        return jnp.sum(o * r), o
    (_, o_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(gp["dec"])
    o_t = ts.dec(_t(z), g=_t(g), x_mask=_t(m))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=1e-4, rtol=1e-4)
    torch.sum(o_t * _t(r)).backward()
    grads = state_from_jax({"dec": _np(g_j)}, set(ts.state_dict()))
    for name, prm in ts.dec.named_parameters():
        want = grads[f"dec.{name}"].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0,
                                   atol=1e-5 + 1e-3 * float(np.abs(want).max()), err_msg=name)


def test_options_train_step_with_the_duration_discriminator_matches_jax(weights):
    """One mel step with -d of the ResBlock1 + Swish model: losses, every G,
    D and P gradient (Swish's scalars among G's) and the updated
    parameters."""
    gp, dp, pp = weights
    opts = (JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01),
            JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0),
            JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0))
    pg, pd, pq = (_Probe(o) for o in opts)
    step_j = jax.jit(j_make_train_step(JSynth(**options_cfg()), JMPD(periods=(2, 3)),
                                       tiny_step_config("mel", use_dur_dis=True), pg, pd,
                                       JDur(HIDDEN, 64, 5), pq), compiler_options=FAST_COMPILE)
    state_j = {"gen": gp, "disc": dp, "dur": pp, "gen_opt": pg.init(gp),
               "disc_opt": pd.init(dp), "dur_opt": pq.init(pp), "step": jnp.zeros((), jnp.int32)}
    b = _batch()
    new_j, m_j = _np(step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(KEY), LR, LR, 0.01, LR_P))

    ts = params_from_jax(gp, TSynth(**options_cfg(), weight_norm=True)).train()
    td = params_from_jax(dp, TMPD(periods=(2, 3))).train()
    tp = params_from_jax(pp, TDur(HIDDEN, 64, 5)).train()
    state = {"gen": ts, "disc": td, "dur": tp, "step": 0, "rng": None,
             "gen_opt": TOptimizer((0.8, 0.99), 1e-9, 0.01).init(ts.parameters()),
             "disc_opt": TOptimizer((0.8, 0.99), 1e-9, 0.0).init(td.parameters()),
             "dur_opt": TOptimizer((0.8, 0.99), 1e-9, 0.0).init(tp.parameters())}
    B, T_x, _ = b["x"].shape
    rng_fwd, _ = jax.random.split(jax.random.PRNGKey(KEY))
    noise = _noise(rng_fwd, B, T_x, b["spec"].shape[1], _cfg()["inter_channels"])
    state, m_t = make_train_step(_cfg_t(True))(state, _torch_batch(b), noise, LR, LR, 0.01,
                                               LR_P)
    np.testing.assert_array_equal(m_t["viz_attn"].numpy(), m_j["viz_attn"])
    assert set(P_KEYS) <= set(m_j)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(ts.dp.act_1.weight.grad.abs().sum()) > 0
    for key, lr in (("gen", LR), ("disc", LR), ("dur", LR_P)):
        model = state[key]
        keys = set(model.state_dict())
        grads = state_from_jax(new_j[f"{key}_opt"][1], keys)
        params = state_from_jax(new_j[key], keys)
        for name, prm in model.named_parameters():
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(prm.grad.numpy(), g_j, atol=g_tol, rtol=0,
                                       err_msg=f"{key}.{name}")
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, 2 * lr, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), f"{key}.{name}"


def _flow_inputs(C=6, B=2, T=9, positive=False):
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, C).astype(np.float32)
    if positive:
        x = np.abs(x) + np.float32(0.05)
    return x, _mask(B, T, (T, T - 3))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_elementwise_affine_matches_jax(reverse):
    x, m = _flow_inputs()
    ea = TM.ElementwiseAffine(6)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        ea.m.copy_(_t(rng.randn(6)))
        ea.logs.copy_(_t(0.3 * rng.randn(6)))
    p = {"m": jnp.asarray(ea.m.detach().numpy()), "logs": jnp.asarray(ea.logs.detach().numpy())}
    out_j = JM.ElementwiseAffine(6).apply(p, jnp.asarray(x), jnp.asarray(m), reverse=reverse)
    out_t = ea(_t(x), _t(m), reverse=reverse)
    if not reverse:
        (y_j, ld_j), (y_t, ld_t) = out_j, out_t
        np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j), atol=1e-5, rtol=1e-6)
        back = ea(y_t, _t(m), reverse=True)
        np.testing.assert_allclose(back.detach().numpy(), x * m, atol=1e-5)
    else:
        y_j, y_t = out_j, out_t
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_log_flow_matches_jax(reverse):
    x, m = _flow_inputs(positive=not reverse)
    x[0, 0, 0] = 1e-7  # below the clamp
    out_j = JM.log_flow(jnp.asarray(x), jnp.asarray(m), reverse=reverse)
    out_t = TM.log_flow(_t(x), _t(m), reverse=reverse)
    if not reverse:
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-5, rtol=1e-6)
        out_j, out_t = out_j[0], out_t[0]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("mean_only", [True, False], ids=["mean_only", "affine"])
def test_coupling_logdet_matches_jax(mean_only):
    """ResidualCouplingLayer in both directions with random post weights:
    the forward's (y, logdet) and the reverse's x, and reverse(forward(x))
    = x."""
    C, H, gin = 8, 16, 16
    tl = init_weights(TM.ResidualCouplingLayer(C, H, 5, 1, 3, gin, weight_norm=True,
                                               mean_only=mean_only),
                      torch.Generator().manual_seed(6))
    with torch.no_grad():  # off the identity the zero init gives
        tl.post.weight.copy_(0.1 * torch.randn(tl.post.weight.shape,
                                               generator=torch.Generator().manual_seed(7)))
        tl.post.bias.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(8))
    p = params_to_jax(tl.state_dict())
    jl = JM.ResidualCouplingLayer(C, H, 5, 1, 3, gin_channels=gin, mean_only=mean_only)
    x, m = _flow_inputs(C)
    g = np.random.RandomState(9).randn(2, gin).astype(np.float32)
    y_j, ld_j = jl.apply(p, jnp.asarray(x), jnp.asarray(m), g=jnp.asarray(g))
    y_t, ld_t = tl(_t(x), _t(m), g=_t(g), reverse=False)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ld_t.detach().numpy(), np.asarray(ld_j), atol=1e-5, rtol=1e-5)
    if mean_only:
        assert not ld_t.any()
    else:
        assert ld_t.abs().min() > 0
    x_j = jl.apply(p, y_j, jnp.asarray(m), g=jnp.asarray(g), reverse=True)
    x_t = tl(y_t, _t(m), g=_t(g), reverse=True)
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x_t.detach().numpy() * m, x * m, atol=1e-5)  # x0 unmasked


@pytest.mark.parametrize("n_fft,hop,win,T",
                         test_istft.test_istft_matches_torch.pytestmark[0].args[1])
def test_istft_matches_jax(n_fft, hop, win, T):
    x = np.random.RandomState(1).randn(3, T).astype(np.float32)
    re, im = JS.stft(jnp.asarray(x), n_fft, hop, win, center=True)
    y_j = np.asarray(JS.istft(re, im, n_fft, hop, win, center=True))
    y_t = TS.istft(_t(re), _t(im), n_fft, hop, win, center=True).numpy()
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, atol=1e-5)
    # center=False keeps the whole overlap-add, whose ends divide by a
    # vanishing window sum; center=True is its interior
    full = TS.istft(_t(re), _t(im), n_fft, hop, win, center=False).numpy()
    assert full.shape[1] == (re.shape[1] - 1) * hop + n_fft
    np.testing.assert_array_equal(full[:, n_fft // 2:n_fft // 2 + y_t.shape[1]], y_t)
    re_t, im_t = TS.stft(_t(x), n_fft, hop, win)  # the port's own round trip
    np.testing.assert_allclose(TS.istft(re_t, im_t, n_fft, hop, win).numpy(),
                               x[:, :y_t.shape[1]], atol=2e-4)


def test_new_leaves_round_trip_through_npz_and_pth(weights, tmp_path):
    """Swish's weights, ResBlock1's 2*inter conv1 and ElementwiseAffine's m
    and logs keep their JAX names and shapes, and come back equal from a
    `.npz` and from a reference `.pth`, in the port and in the JAX
    package."""
    gp = weights[0]
    shapes = jax.eval_shape(JSynth(**options_cfg()).init_params, jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    ours = dict(jax.tree_util.tree_flatten_with_path(gp)[0])
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ours.items()}
    assert gp["dp"]["act_1"]["weight"].shape == (1,)
    np.testing.assert_array_equal(gp["dp"]["act_2"]["weight"], np.float32([SWISH[1]]))

    tck.save_checkpoint(str(tmp_path / "G.npz"), {"model": gp})
    back, _, _ = tck.load_checkpoint(str(tmp_path / "G.npz"), {"model": gp})
    save_torch_checkpoint(str(tmp_path / "G.pth"), gp)
    template = tree_template(lambda: TSynth(**options_cfg(), weight_norm=True))
    from_pth = load_torch_checkpoint(str(tmp_path / "G.pth"), template)
    j_pth = j_load_torch_checkpoint(str(tmp_path / "G.pth"), _np(shapes_zero(shapes)))
    for tree in (back["model"], from_pth, _np(j_pth)):
        got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert set(got) == set(ours)
        for k, v in ours.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=str(k))
    ts = params_from_jax(from_pth, TSynth(**options_cfg(), weight_norm=True))
    assert float(ts.dp.act_1.weight.detach()) == np.float32(SWISH[0])

    ea = TM.ElementwiseAffine(4)
    with torch.no_grad():
        ea.m.copy_(torch.arange(4.0))
        ea.logs.copy_(-torch.arange(4.0))
    tree = params_to_jax(ea.state_dict())
    assert set(tree) == {"m", "logs"}
    again = params_from_jax(tree, TM.ElementwiseAffine(4))
    assert torch.equal(again.m, ea.m) and torch.equal(again.logs, ea.logs)


def shapes_zero(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_int8_is_refused_on_a_resblock1_decoder(weights):
    js = JSynth(**options_cfg())
    ts = params_from_jax(weights[0], TSynth(**options_cfg()))
    z = torch.zeros(1, 8, _cfg()["inter_channels"])
    g = torch.zeros(1, _cfg()["gin_channels"])
    with pytest.raises(NotImplementedError, match="ResBlock2") as e_t:
        ts.quantize_decoder(z, g)
    with pytest.raises(NotImplementedError, match="ResBlock2") as e_j:
        js.dec.quantize(weights[0]["dec"], {})
    assert str(e_t.value) == str(e_j.value)
    for call in (lambda: ts.dec.forward_q8({}, z, g), lambda: ts.dec.quantize({})):
        with pytest.raises(NotImplementedError, match="ResBlock2"):
            call()


def test_an_unknown_activation_is_refused():
    with pytest.raises(ValueError, match="unsupported act_func gelu"):
        TSynth(**{**_cfg(), "act_func_d": "gelu"})


@pytest.mark.parametrize("T", [30, 40], ids=["within_max_pos", "past_max_pos"])
def test_the_position_table_is_built_once_and_bit_equal(T):
    """The text encoder's table is a non-persistent buffer of max_pos rows
    (no state-dict entry; strict loading unchanged), and its output is
    bit-equal to the one of a table built per call of max(max_pos, T)
    rows, within max_pos and past it."""
    h, max_pos = 16, 32
    enc = init_weights(TextEncoder(8, 8, h, 24, 2, 2, 3, gin_channels=16, max_pos=max_pos),
                       torch.Generator().manual_seed(10)).eval()
    assert "pe" not in enc.state_dict() and tuple(enc.pe.shape) == (1, max_pos, h)
    enc.load_state_dict(enc.state_dict(), strict=True)
    rng = np.random.RandomState(T)
    x, emo, g = _t(rng.randn(1, T, 8)), _t(rng.randn(1, 1024)), _t(rng.randn(1, 16))
    with torch.no_grad():
        got = enc(x, None, emo=emo, g=g)
        pe = torch.from_numpy(gen_sin_table(max(max_pos, T), h)[:, :T])
        e = enc.emb["1"](enc.emb["0"](x)) + enc.emo_proj(emo)[:, None, :]
        want_x = enc.encoder(e * math.sqrt(h) + pe * enc.alpha, None, g=g)
    assert torch.equal(got[0], want_x)


def test_infer_p1_exports_with_a_dynamic_text_axis(weights):
    ts = params_from_jax(weights[0], TSynth(**options_cfg())).eval()

    class P1(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.s = ts

        def forward(self, x, emo, sid):
            return self.s.infer_p1(x, emo, sid)

    T = torch.export.Dim("T", min=2, max=ts.enc_p.max_pos)
    c = _cfg()
    args = (torch.zeros(1, 12, c["text_channels"]), torch.zeros(1, 1024),
            torch.zeros(1, dtype=torch.long))
    prog = torch.export.export(P1(), args, dynamic_shapes=({1: T}, None, None),
                               strict=False).module()
    rng = np.random.RandomState(11)
    for t_x in (5, 12, 31):
        x, emo = _t(rng.randn(1, t_x, c["text_channels"])), _t(rng.randn(1, 1024))
        sid = torch.tensor([3])
        for a, b in zip(prog(x, emo, sid), ts.infer_p1(x, emo, sid)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
