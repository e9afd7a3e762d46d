"""The port's training layers against the JAX package on the CPU, with the
same numpy inputs: weight-norm Dense/Conv1d/ConvTranspose1d/Conv2d (outputs
and the gradients of g and v), the STFT/spectrogram/mel DSP and its gradient,
the sequence ops of the training step, dropout, and AdamW against optax.

Tolerances: layers and sequence ops atol 1e-5 (fp32, sums in another order);
STFT outputs atol 2e-4 and mel atol 1e-4 (a 64-point DFT of unit-scale
frames: the JAX package's jitted basis is computed in f32, the port's in
f64); gradients rtol 1e-4 on top of those atols; AdamW rtol 1e-6 after three
steps (torch applies the decay as p * (1 - lr * wd) before the Adam step,
optax adds wd * p to it: the same sum rounded in another order, an ulp or
two)."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from vits_tpu.nn import core as jcore
from vits_tpu.ops import seq as jseq
from vits_tpu.ops import stft as jstft
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.optim import exponential_lr as j_exponential_lr

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.nn import core as tcore
from vits_tpu_torch.ops import seq as tseq
from vits_tpu_torch.ops import stft as tstft
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.optim import exponential_lr

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(want, got, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), atol=atol, rtol=rtol)


def _layers(case):
    if case == "dense":
        return jcore.Dense(8, 6, weight_norm=True), tcore.Dense(8, 6, weight_norm=True), (2, 13, 8)
    if case == "conv1d":
        return (jcore.Conv1d(8, 6, 5, padding=4, dilation=2, weight_norm=True),
                tcore.Conv1d(8, 6, 5, padding=4, dilation=2, weight_norm=True), (2, 13, 8))
    if case == "conv1d_grouped_strided":
        return (jcore.Conv1d(8, 12, 7, stride=4, groups=4, padding=3, weight_norm=True),
                tcore.Conv1d(8, 12, 7, padding=3, groups=4, stride=4, weight_norm=True),
                (2, 29, 8))
    if case == "convT":
        return (jcore.ConvTranspose1d(8, 4, 12, 6, padding=3, weight_norm=True),
                tcore.ConvTranspose1d(8, 4, 12, 6, padding=3, weight_norm=True), (2, 13, 8))
    return (jcore.Conv2d(4, 6, (5, 1), (3, 1), (2, 0), weight_norm=True),
            tcore.Conv2d(4, 6, (5, 1), (3, 1), (2, 0), weight_norm=True), (2, 17, 3, 4))


@pytest.mark.parametrize("case", ["dense", "conv1d", "conv1d_grouped_strided", "convT",
                                  "conv2d"])
def test_weight_norm_layer_and_grads(case):
    """Trainable g/v layers: the forward, and the gradients of g, v and the
    bias of <y, r>, equal to the JAX layer's; the JAX tree round-trips."""
    jl, tl, shape = _layers(case)
    rng = np.random.RandomState(0)
    p = _np(jax.jit(jl.init_params)(jax.random.PRNGKey(1)))
    p["g"] = p["g"] * rng.uniform(0.5, 1.5, p["g"].shape).astype(np.float32)
    if case == "convT":  # the converter knows a transposed conv under "ups"
        tl = params_from_jax({"ups": {"0": p}}, nn.ModuleDict({"ups": nn.ModuleDict(
            {"0": tl})}))["ups"]["0"]
    else:
        tl = params_from_jax(p, tl)
    x = rng.randn(*shape).astype(np.float32)
    y_j = jl.apply(p, jnp.asarray(x))
    r = rng.randn(*y_j.shape).astype(np.float32)
    y_t = tl(_t(x))
    _close(y_j, y_t)
    grads_j = _np(jax.grad(lambda p: jnp.sum(jl.apply(p, jnp.asarray(x)) * r))(p))
    torch.sum(y_t * _t(r)).backward()
    if case == "convT":
        want = {k[len("ups.0."):]: v for k, v in state_from_jax(
            {"ups": {"0": grads_j}}, {"ups.0." + k for k in tl.state_dict()}).items()}
    else:
        want = state_from_jax(grads_j, set(tl.state_dict()))
    for name, prm in tl.named_parameters():
        _close(want[name], prm.grad, atol=1e-4, rtol=1e-4)
    if case == "convT":
        back = params_to_jax({"ups.0." + k: v for k, v in tl.state_dict().items()})["ups"]["0"]
    else:
        back = params_to_jax(tl.state_dict())
    for k in ("g", "v", "b"):
        np.testing.assert_array_equal(back[k], p[k])


def test_stft_spectrogram_mel_and_grad():
    rng = np.random.RandomState(1)
    y = rng.uniform(-0.5, 0.5, (2, 8 * 24)).astype(np.float32)
    n_fft, hop, win, n_mels, sr = 64, 8, 48, 20, 1600
    re_j, im_j = jstft.stft(jnp.asarray(y), n_fft, hop, win, center=True)
    re_t, im_t = tstft.stft(_t(y), n_fft, hop, win, center=True)
    _close(re_j, re_t, atol=2e-4)
    _close(im_j, im_t, atol=2e-4)
    _close(jstft.spectrogram(jnp.asarray(y), n_fft, hop, win),
           tstft.spectrogram(_t(y), n_fft, hop, win), atol=2e-4)
    np.testing.assert_array_equal(tstft.mel_filterbank(sr, n_fft, n_mels),
                                  jstft.mel_filterbank(sr, n_fft, n_mels))
    np.testing.assert_array_equal(tstft.hann_window(win), jstft.hann_window(win))
    spec = np.abs(rng.randn(2, 24, n_fft // 2 + 1)).astype(np.float32)
    _close(jstft.spec_to_mel(jnp.asarray(spec), n_fft, n_mels, sr),
           tstft.spec_to_mel(_t(spec), n_fft, n_mels, sr), atol=1e-4)
    mel_j = jstft.mel_spectrogram(jnp.asarray(y), n_fft, n_mels, sr, hop, win)
    yt = _t(y).requires_grad_(True)
    mel_t = tstft.mel_spectrogram(yt, n_fft, n_mels, sr, hop, win)
    _close(mel_j, mel_t, atol=1e-4)
    _close(jstft.dynamic_range_compression(jnp.asarray(spec) - 1.0),
           tstft.dynamic_range_compression(_t(spec) - 1.0))
    # the gradient through the framed matmul against the JAX custom VJP
    r = rng.randn(*mel_j.shape).astype(np.float32)
    g_j = jax.grad(lambda w: jnp.sum(jstft.mel_spectrogram(w, n_fft, n_mels, sr, hop, win)
                                     * r))(jnp.asarray(y))
    torch.sum(mel_t * _t(r)).backward()
    _close(g_j, yt.grad, atol=1e-4, rtol=1e-4)


def test_seq_ops_for_training():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 20, 5).astype(np.float32)
    # the last start lies past T - size: dynamic_slice clamps it to 12
    ids = np.array([0, 7, 15], np.int32)
    _close(jseq.slice_segments(jnp.asarray(x), jnp.asarray(ids), 8),
           tseq.slice_segments(_t(x), torch.from_numpy(ids), 8), atol=0)
    # a negative start counts from the end, as lax.dynamic_slice takes it
    _close(jseq.slice_segments_1d(jnp.asarray(x[..., 0]), jnp.asarray(ids * 2 - 1), 8),
           tseq.slice_segments_1d(_t(x[..., 0]), torch.from_numpy(ids * 2 - 1), 8), atol=0)
    np.testing.assert_array_equal(tseq.slice_segments(_t(x), torch.tensor([15]), 8)[0].numpy(),
                                  x[0, 12:20])
    lengths = np.array([20, 9, 5], np.int32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (3,)))
    seg_j, ids_j = jseq.rand_slice_segments(key, jnp.asarray(x), jnp.asarray(lengths), 8)
    seg_t, ids_t = tseq.rand_slice_segments(_t(x), torch.from_numpy(lengths), 8, _t(u))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _close(seg_j, seg_t, atol=0)
    m_p, logs_p, m_q, logs_q = (rng.randn(2, 7, 3).astype(np.float32) * 0.5 for _ in range(4))
    _close(jseq.kl_divergence(*map(jnp.asarray, (m_p, logs_p, m_q, logs_q))),
           tseq.kl_divergence(*map(_t, (m_p, logs_p, m_q, logs_q))))
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    _, norm_j = jseq.clip_grad_value([jnp.asarray(g) for g in grads], None)
    params = [nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for prm, g in zip(params, grads):
        prm.grad = _t(g)
    _close(norm_j, tseq.clip_grad_value(params))


def test_dropout():
    x = torch.randn(64, 256)
    assert tcore.dropout(x, 0.0) is x
    gen = torch.Generator().manual_seed(0)
    y = tcore.dropout(x, 0.25, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    y2 = tcore.dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, y2, rtol=0, atol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_optax(weight_decay):
    """torch.optim.AdamW behind the port's Optimizer against the JAX
    package's optax chain (scale_by_adam -> add_decayed_weights -> scale(-lr))
    over three steps with changing learning rates."""
    rng = np.random.RandomState(4)
    p0 = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jopt = JOptimizer("adamw", (0.8, 0.99), 1e-9, weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: nn.Parameter(_t(v)) for k, v in p0.items()}
    topt = TOptimizer((0.8, 0.99), 1e-9, weight_decay)
    ts = topt.init(tp.values())
    for step, lr in enumerate((1e-2, 5e-3, 2e-3)):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k in tp:
            tp[k].grad = _t(g[k])
        topt.update(ts, lr)
        for k in tp:
            _close(jp[k], tp[k], atol=1e-7, rtol=1e-6)
    for epoch in (0, 1, 7):
        assert exponential_lr(2e-4, 0.999875, epoch) == j_exponential_lr(2e-4, 0.999875, epoch)
