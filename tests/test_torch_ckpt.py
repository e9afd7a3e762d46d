"""Checkpoints across the two packages at TINY on the CPU: the JAX
package's `.npz` format, parameters and AdamW state, read both ways
(`__graft_entry__._tiny_cfg()` with both dropout rates 0, MPD periods 2 and
3, the duration discriminator at the loop's widths, `-d` steps); and the
same for the stft/MRD variant (`tiny_mrd_disc()`, RAdam for D and P as the
loop builds them, spectral norm's u among the D leaves, with the zero
moments the JAX tree keeps for each u).

Each package takes one step from the same weights and saves; the other
package's loader fills a FRESH state of its own from that file (every leaf
of the JAX template present in a port-written file), and parameters, Adam
moments, counts and learning rates carry EXACTLY (float32 through the
layout transforms). Then both packages take one more step from the file's
state on the same batch and noise, held by tests/test_torch_train.py's
tolerances: losses and gradient norms rtol 1e-4, atol 1e-6; gradients atol
1e-5 + 1e-3 of the tensor's largest magnitude; updated parameters atol 1e-6
+ 1e-4 relative, and up to 2 * lr where the step's gradient element lies
within that tolerance of zero (an Adam update is at most about lr).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_dur_disc import HIDDEN, LOSS_KEYS, LR_P, P_KEYS, _cfg_t, weights  # noqa: F401
from test_torch_stft_train import port_cfg as _stft_cfg_t
from test_torch_stft_train import tiny_mrd
from test_torch_train import (FAST_COMPILE, LR, _batch, _cfg, _noise, _np, _Probe,  # noqa: F401
                              _torch_batch, one_torch_thread)
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import DurationDiscriminator as JDur
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils import checkpoint as jck
from vits_tpu.utils.tiny import tiny_mrd_disc, tiny_step_config

from vits_tpu_torch.config import HParams
from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import DurationDiscriminator as TDur
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.loop import resume, save_all
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import make_train_step
from vits_tpu_torch.utils import checkpoint as tck

PARTS = (("G", "gen"), ("D", "disc"), ("P", "dur"))
LRS = {"gen": LR, "disc": LR, "dur": LR_P}
J_OPTS = {"gen": JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01),
          "disc": JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0),
          "dur": JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0)}
# the stft variant's, as both loops build them: RAdam for D and P
J_OPTS_STFT = {"gen": J_OPTS["gen"], "disc": JOptimizer("radam", (0.8, 0.99), 1e-9, 0.0),
               "dur": JOptimizer("radam", (0.8, 0.99), 1e-9, 0.0)}
STFT_LOSS_KEYS = ("loss_disc", "loss_gen", "loss_stft", "loss_dur", "loss_kl", "loss_kl_q",
                  "loss_g_total", "losses_d_r", "losses_d_g", "losses_g", "grad_norm_d",
                  "grad_norm_g") + P_KEYS


def _fresh_port_state(seed=99, variant="mel"):
    """A port training state with -d, its weights from another seed than the
    ones under test, so that what a load leaves in it came from the file."""
    gen = torch.Generator().manual_seed(seed)
    disc = TMPD(periods=(2, 3)) if variant == "mel" else tiny_mrd()
    models = {"gen": init_weights(TSynth(**_cfg(), weight_norm=True), gen).train(),
              "disc": init_weights(disc, gen).train(),
              "dur": init_weights(TDur(HIDDEN, 64, 5), gen).train()}
    state = {"step": 0, "rng": None}
    for key, m in models.items():
        wd = 0.01 if key == "gen" else 0.0
        kind = "radam" if variant == "stft" and key != "gen" else "adamw"
        state[key] = m
        state[f"{key}_opt"] = TOptimizer((0.8, 0.99), 1e-9, wd, kind).init(m.parameters())
    return state


def _port_from_weights(weights, variant="mel"):
    state = _fresh_port_state(variant=variant)
    for (_, key), tree in zip(PARTS, weights):
        params_from_jax(tree, state[key])
    return state


def _zeros_like_init(model, opt):
    """{"model", "optimizer"} of the structure, shapes and dtypes that JAX's
    own `init_params` and optimizer `init` make, as zeros (traced
    abstractly: an eager init at these widths takes half a minute)."""
    def init(key):
        p = model.init_params(key)
        return {"model": p, "optimizer": opt.init(p)}
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _jax_template(variant="mel"):
    opts = J_OPTS if variant == "mel" else J_OPTS_STFT
    disc = JMPD(periods=(2, 3)) if variant == "mel" else tiny_mrd_disc()
    return {"gen": _zeros_like_init(JSynth(**_cfg()), opts["gen"]),
            "disc": _zeros_like_init(disc, opts["disc"]),
            "dur": _zeros_like_init(JDur(HIDDEN, 64, 5), opts["dur"])}


def _batch_noise(seed, key):
    b = _batch(seed=seed)
    rng_fwd, _ = jax.random.split(jax.random.PRNGKey(key))
    noise = _noise(rng_fwd, b["x"].shape[0], b["x"].shape[1], b["spec"].shape[1],
                   _cfg()["inter_channels"])
    return b, noise


def _make_j_step(variant):
    opts = J_OPTS if variant == "mel" else J_OPTS_STFT
    probes = {k: _Probe(o) for k, o in opts.items()}
    cfg = tiny_step_config(variant, use_dur_dis=True)
    disc = JMPD(periods=(2, 3)) if variant == "mel" else tiny_mrd_disc()
    fn = jax.jit(j_make_train_step(JSynth(**_cfg()), disc, cfg,
                                   probes["gen"], probes["disc"], JDur(HIDDEN, 64, 5),
                                   probes["dur"]), compiler_options=FAST_COMPILE)

    def step(trees, opt_states, count, seed, key):
        state = {"step": jnp.asarray(count, jnp.int32)}
        for k in trees:
            state[k] = trees[k]
            state[f"{k}_opt"] = (opt_states[k], jax.tree_util.tree_map(jnp.zeros_like,
                                                                        trees[k]))
        b, _ = _batch_noise(seed, key)
        new, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(key),
                    LR, LR, 0.01, LR_P)
        return _np(new), _np(m)
    return step


@pytest.fixture(scope="module")
def j_step():
    return _make_j_step("mel")


@pytest.fixture(scope="module")
def j_step_stft():
    return _make_j_step("stft")


@pytest.fixture(scope="module")
def stft_weights():
    gen = torch.Generator().manual_seed(5)
    models = (TSynth(**_cfg(), weight_norm=True), tiny_mrd(), TDur(HIDDEN, 64, 5))
    return tuple(params_to_jax(init_weights(m, gen).state_dict()) for m in models)


def _t_step(state, seed, key, variant="mel"):
    b, noise = _batch_noise(seed, key)
    cfg = _cfg_t(True) if variant == "mel" else _stft_cfg_t(use_dur_dis=True)
    return make_train_step(cfg)(state, _torch_batch(b), noise, LR, LR, 0.01, LR_P)


def _assert_carried(port_state, j_loaded, count):
    """The port state equals the JAX state leaf for leaf after the layout
    transform: parameters, spectral norm's u (whose moments are zero in the
    JAX tree), both moments, the count and the lr."""
    for _, key in PARTS:
        model, opt = port_state[key], port_state[f"{key}_opt"]
        keys = set(model.state_dict())
        params = state_from_jax(j_loaded[key]["model"], keys)
        o = j_loaded[key]["optimizer"]
        adam = o.inner_state[0]
        mu, nu = state_from_jax(adam.mu, keys), state_from_jax(adam.nu, keys)
        assert int(o.count) == int(adam.count) == count
        assert opt.param_groups[0]["lr"] == float(np.float32(LRS[key]))
        assert float(o.hyperparams["learning_rate"]) == float(np.float32(LRS[key]))
        for name, p in model.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == count, name
            assert torch.equal(p.detach(), params[name]), f"{key}.{name}"
            assert torch.equal(st["exp_avg"], mu[name]), f"{key}.{name} mu"
            assert torch.equal(st["exp_avg_sq"], nu[name]), f"{key}.{name} nu"
        for name, b in model.named_buffers():
            if name not in keys:  # a non-persistent buffer (the position table)
                continue
            assert torch.equal(b, params[name]), f"{key}.{name}"
            assert not mu[name].any() and not nu[name].any(), f"{key}.{name} moments"


def _resume_across(weights, j_step, tmp_path, writer, variant):
    """`writer` takes one step from `weights` and saves G/D/P_1.npz; the JAX
    package loads them into its own template and the port resumes a fresh
    state from them, every leaf carried; then each takes one more step."""
    template = _jax_template(variant)
    if writer == "jax":
        opt0 = {k: t["optimizer"] for k, t in template.items()}  # zeros: a fresh optimizer
        new, _ = j_step(dict(zip(("gen", "disc", "dur"), weights)), opt0, 0, 0, 21)
        for prefix, key in PARTS:
            jck.save_checkpoint(str(tmp_path / f"{prefix}_1.npz"),
                                {"model": new[key], "optimizer": new[f"{key}_opt"][0]},
                                step=1, epoch=1)
    else:
        state, _ = _t_step(_port_from_weights(weights, variant), 0, 21, variant)
        assert state["step"] == 1
        save_all(HParams(model_dir=str(tmp_path)), state, 1)

    # the JAX package loads the file into its own template: every leaf there
    j_loaded = {}
    for prefix, key in PARTS:
        path = str(tmp_path / f"{prefix}_1.npz")
        with np.load(path) as z:
            files = {k: z[k].shape for k in z.files}
        flat_t = jck._flatten(jax.device_get(template[key]))
        assert all(k in files and files[k] == v.shape for k, v in flat_t.items()
                   if not k.endswith("__empty__")), prefix
        assert set(files) - set(flat_t) == {"__step__", "__epoch__"}, prefix
        j_loaded[key], step, epoch = jck.load_checkpoint(path, template[key])
        assert (step, epoch) == (1, 1)

    # the port resumes a fresh state from the same files
    port, epoch = resume(HParams(model_dir=str(tmp_path), use_dur_dis=True),
                         _fresh_port_state(variant=variant))
    assert port["step"] == 1 and epoch == 1
    _assert_carried(port, j_loaded, 1)

    # one more step in each package from the file's state
    new_j, m_j = j_step({k: j_loaded[k]["model"] for k in j_loaded},
                        {k: j_loaded[k]["optimizer"] for k in j_loaded}, 1, 1, 22)
    port, m_t = _t_step(port, 1, 22, variant)
    assert port["step"] == 2 and int(new_j["step"]) == 2
    for k in (LOSS_KEYS if variant == "mel" else STFT_LOSS_KEYS):
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for _, key in PARTS:
        model = port[key]
        keys = set(model.state_dict())
        grads = state_from_jax(new_j[f"{key}_opt"][1], keys)
        params = state_from_jax(new_j[key], keys)
        assert int(new_j[f"{key}_opt"][0].count) == 2
        for name, prm in model.named_parameters():
            assert int(port[f"{key}_opt"].state[prm]["step"]) == 2
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(prm.grad.numpy(), g_j, atol=g_tol, rtol=0,
                                       err_msg=f"{key}.{name}")
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol,
                                                         2 * LRS[key], 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), f"{key}.{name}"
        for name, b in model.named_buffers():  # u after the second step's power iteration
            if name not in keys:  # a non-persistent buffer (the position table)
                continue
            u_j = params[name].numpy()
            assert np.all(np.abs(b.numpy() - u_j) <= 1e-6 + 1e-4 * np.abs(u_j)), f"{key}.{name}"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_from_the_others_checkpoint(weights, j_step, tmp_path, writer):
    _resume_across(weights, j_step, tmp_path, writer, "mel")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_an_stft_run_from_the_others_checkpoint(stft_weights, j_step_stft,
                                                                     tmp_path, writer):
    """The stft variant's G/D/P_1.npz, with RAdam's state for D and P and
    spectral norm's u, read both ways, then one more step in each package."""
    _resume_across(stft_weights, j_step_stft, tmp_path, writer, "stft")


def test_adapt_loads_the_models_and_resets_step_and_optimizer(weights, tmp_path):
    state, _ = _t_step(_port_from_weights(weights), 0, 21)
    save_all(HParams(model_dir=str(tmp_path)), state, 3)
    hps = HParams(model_dir=str(tmp_path), use_dur_dis=True, adapt=True)
    fresh, epoch = resume(hps, _fresh_port_state())
    assert fresh["step"] == 0 and epoch == 1
    for _, key in PARTS:
        assert not fresh[f"{key}_opt"].state
        assert fresh[f"{key}_opt"].param_groups[0]["lr"] == 0.0
        live = dict(state[key].named_parameters())
        for name, p in fresh[key].named_parameters():
            assert torch.equal(p, live[name]), name
    hps.adapt = False
    kept, epoch = resume(hps, _fresh_port_state())
    assert kept["step"] == 1 and epoch == 3 and kept["gen_opt"].state


def _small_tree(rng):
    return {"model": {"a": {"w": rng.randn(3, 4).astype(np.float32)},
                      "b": rng.randn(5).astype(np.float32)},
            "n": np.asarray(rng.randint(0, 9), np.int32)}


def test_checkpoint_files_helpers_match_jax(tmp_path):
    """latest_checkpoint_path (digit sort), greedy_soup, prune_checkpoints
    and the tolerant merge (a missing leaf and a leaf of another shape keep
    the template's value) against the JAX package's on the same files."""
    rng = np.random.RandomState(0)
    trees = {}
    for step in (1, 10, 2, 100, 20):
        trees[step] = _small_tree(rng)
        tck.save_checkpoint(str(tmp_path / f"G_{step}.npz"), trees[step], step=step, epoch=2,
                            extra={"note": 7})
    assert tck.latest_checkpoint_path(str(tmp_path)) == \
        jck.latest_checkpoint_path(str(tmp_path)) == str(tmp_path / "G_100.npz")
    paths = tck.checkpoint_paths_sorted(str(tmp_path))
    assert paths == jck.checkpoint_paths_sorted(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [f"G_{s}.npz" for s in (1, 2, 10, 20, 100)]
    template = _small_tree(rng)
    soup_t = tck.greedy_soup(paths, template, greedy=3)
    soup_j = jax.device_get(jck.greedy_soup(paths, template, greedy=3))
    for k in ("a", "b"):
        a_t = soup_t["model"][k]["w"] if k == "a" else soup_t["model"][k]
        a_j = soup_j["model"][k]["w"] if k == "a" else soup_j["model"][k]
        assert a_t.dtype == np.float32
        np.testing.assert_array_equal(a_t, np.asarray(a_j))
    assert soup_t["n"] == soup_j["n"] and soup_t["n"].dtype == np.int32

    odd = {"model": {"a": {"w": np.zeros((4, 3), np.float32)}, "b": np.ones(5, np.float32),
                     "c": np.full(2, 7.0, np.float32)}, "n": np.asarray(0, np.int32)}
    got_t, step_t, ep_t = tck.load_checkpoint(paths[-1], odd)
    got_j, step_j, ep_j = jck.load_checkpoint(paths[-1], odd)
    assert (step_t, ep_t) == (step_j, ep_j) == (100, 2)
    np.testing.assert_array_equal(got_t["model"]["a"]["w"], odd["model"]["a"]["w"])
    np.testing.assert_array_equal(got_t["model"]["c"], odd["model"]["c"])
    np.testing.assert_array_equal(got_t["model"]["b"], trees[100]["model"]["b"])
    for k in ("b", "c"):
        np.testing.assert_array_equal(got_t["model"][k], np.asarray(got_j["model"][k]))
    assert tck.read_checkpoint(paths[-1])[1:] == (100, 2)

    tck.prune_checkpoints(str(tmp_path), keep=2)
    assert [os.path.basename(p) for p in tck.checkpoint_paths_sorted(str(tmp_path))] == \
        ["G_20.npz", "G_100.npz"]
