"""Data-parallel training of the port (`vits_tpu_torch.parallel.dist`) on the
CPU over gloo, against the JAX package's data-parallel step.

Ranks are spawned processes (tests/torch_ddp_rank.py: torch and the port
only) that meet through a `file://` store under the test's tmp_path, so
parallel test workers never contend for a port; each is joined with a
timeout of its own. Torch runs on one intra-op thread in every process.

Parity: one TINY step of 2 ranks, 2 utterances each, with unequal lengths
across the ranks (rank 0 long, rank 1 short), against
`vits_tpu.parallel.mesh.make_sharded_train_step` over a 2-device CPU mesh
on the concatenated batch, from the same weights (the port's seeded
initialisation carried by `params_to_jax`), each rank given its half of the
noise the JAX graph draws from its key. The mel step, the mel step with the
duration discriminator, and the stft step. Tolerances, those of
tests/test_torch_train.py: the summed losses rtol 1e-4 (atol 1e-6); every
summed gradient atol 1e-5 + 1e-3 of the tensor's largest magnitude; the
updated parameters atol 1e-6 + 1e-4 relative, plus up to 2 * lr where a
gradient element lies within that tolerance of zero (AdamW's first update is
about lr * sign(g); RAdam's momentum step needs no such allowance); rank 0's
MAS path EQUAL; the two ranks' parameters bit-equal. The control: the mean
of the ranks' one-process losses (rank-local normalisers, what averaging
rank-local losses computes) misses the JAX KL and duration losses by more
than the loss tolerance at these lengths.

Float64: 4 ranks of 2 utterances each (unequal lengths across them) take
the mel step with the duration discriminator in float64 (the models in
float64 and `TrainStepConfig.compute_dtype` float64) against
one process on the concatenated batch in float64: the summed losses within
1e-9 relative, every summed gradient within 1e-9 of the tensor's largest
magnitude, the MAS paths equal. float64 leaves summation order about 1e-16
relative, so a rank split that changed the function shows far above that;
the float32 comparisons above cannot tell such a fault from rounding.

The CLIs: `python -m torch.distributed.run --nproc_per_node 2 -m
vits_tpu_torch.train ... --device cpu` on the TINY corpus of
tests/test_loop.py (the ranks' digests equal, only rank 0's files, the JAX
package reads every leaf of the checkpoints), and `train_stft.main` on two
spawned ranks with the TINY MRD, then again from its checkpoints; one
process with WORLD_SIZE=1 computes what it computes with WORLD_SIZE unset.
"""

import json
import multiprocessing
import os
import pickle
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ddp_rank
from test_loop import make_corpus, make_hps
from test_torch_dur_disc import HIDDEN
from test_torch_stft_train import tiny_mrd
from test_torch_train import LR, _batch, _cfg, _noise, _np, _Probe, \
    one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import DurationDiscriminator as JDur
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.parallel.mesh import make_mesh, make_sharded_train_step
from vits_tpu.train import loop as JL
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils import checkpoint as jck
from vits_tpu.utils.tiny import tiny_mrd_disc, tiny_step_config

from vits_tpu_torch.config import HParams
from vits_tpu_torch.convert import params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import DurationDiscriminator as TDur
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.parallel import dist
from vits_tpu_torch.train import loop as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_S = 120
LR_P = 1e-4
KEY = 21
# rank 0's two utterances are long, rank 1's short: the ranks' masks differ
X_LENGTHS = (11, 10, 6, 5)
SPEC_LENGTHS = (24, 22, 14, 12)
MRD = dict(num_dwt=2, wave_layers=4, fft_sizes=(64, 32), hop_sizes=(16, 8),
           win_sizes=(64, 32), stft_num_layers=(3, 3), stft_kernel_sizes=(3, 3),
           stft_conv_channels=(8, 8))  # tiny_mrd()'s
CASES = {"mel": ("mel", False), "mel-d": ("mel", True), "stft": ("stft", True)}


def _spawn(tmp_path, fn, *args, world=WORLD):
    """Run `fn(rank, world, store, *args, out)` on `world` spawned ranks;
    their pickled results, once every rank has exited 0 within JOIN_S
    seconds (`_join`)."""
    ctx = multiprocessing.get_context("spawn")
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=fn, args=(r, world, str(store), *args, str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def _join(procs, outs):
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    assert not alive, f"{len(alive)} rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _global_batch():
    b = _batch(B=4)
    b["x_lengths"] = np.array(X_LENGTHS, np.int32)
    b["spec_lengths"] = np.array(SPEC_LENGTHS, np.int32)
    return b


def _weights(variant, use_dur_dis):
    gen = torch.Generator().manual_seed(5)
    models = [TSynth(**_cfg(), weight_norm=True),
              tiny_mrd() if variant == "stft" else TMPD(periods=(2, 3))]
    if use_dur_dis:
        models.append(TDur(HIDDEN, 64, 5))
    return [params_to_jax(init_weights(m, gen).state_dict()) for m in models]


def _jax_mesh_step(variant, use_dur_dis, weights, b):
    """The JAX step over a 2-device data mesh on the global batch, its
    optimizers probed (the gradients they were given kept in their state)."""
    kind = "radam" if variant == "stft" else "adamw"
    probes = [_Probe(JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01)),
              _Probe(JOptimizer(kind, (0.8, 0.99), 1e-9, 0.0))]
    disc = tiny_mrd_disc() if variant == "stft" else JMPD(periods=(2, 3))
    extra = ()
    state = {"gen": weights[0], "disc": weights[1], "step": jnp.zeros((), jnp.int32)}
    if use_dur_dis:
        probes.append(_Probe(JOptimizer(kind, (0.8, 0.99), 1e-9, 0.0)))
        extra = (JDur(HIDDEN, 64, 5), probes[2])
        state.update(dur=weights[2], dur_opt=probes[2].init(weights[2]))
    state.update(gen_opt=probes[0].init(weights[0]), disc_opt=probes[1].init(weights[1]))
    cfg = tiny_step_config(variant, use_dur_dis=use_dur_dis)
    step = j_make_train_step(JSynth(**_cfg()), disc, cfg, probes[0], probes[1], *extra)
    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    new, m = make_sharded_train_step(step, mesh)(
        state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(KEY),
        LR, LR, 0.01, LR_P)
    return _np(new), _np(m)


def _job(variant, use_dur_dis, weights, b):
    c = tiny_step_config(variant)
    cfg = dict(segment_frames=c.segment_frames, hop_length=c.hop_length,
               filter_length=c.filter_length, win_length=c.win_length,
               n_mel_channels=c.n_mel_channels, sampling_rate=c.sampling_rate,
               variant=variant, use_dur_dis=use_dur_dis)
    B, T_x, _ = b["x"].shape
    rng_fwd, _ = jax.random.split(jax.random.PRNGKey(KEY))
    job = {"cfg": cfg, "synth": _cfg(), "mrd": MRD, "gen": weights[0], "disc": weights[1],
           "batch": {k: torch.from_numpy(v).long() if k == "sid" else torch.from_numpy(v)
                     for k, v in b.items()},
           "noise": _noise(rng_fwd, B, T_x, b["spec"].shape[1], _cfg()["inter_channels"]),
           "lrs": (LR, LR, 0.01, LR_P)}
    if use_dur_dis:
        job.update(dur=weights[2], dur_args=(HIDDEN, 64, 5))
    return job


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Each case's ranks, all spawned at once, and its JAX mesh step, the
    three compiled on threads of their own while the ranks run (XLA's
    compiler releases the GIL)."""
    b = _global_batch()
    weights = {case: _weights(*CASES[case]) for case in CASES}
    ranks = {case: _spawn(tmp_path_factory.mktemp(case), torch_ddp_rank.step_rank,
                          _job(*CASES[case], weights[case], b)) for case in CASES}
    with ThreadPoolExecutor(len(CASES)) as pool:
        jax_steps = {case: pool.submit(_jax_mesh_step, *CASES[case], weights[case], b)
                     for case in CASES}
        jax_steps = {case: f.result() for case, f in jax_steps.items()}
    return {case: (_join(*ranks[case]), jax_steps[case]) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_take_the_jax_mesh_step_on_the_global_batch(case, parity):
    variant, use_dur_dis = CASES[case]
    (r0, r1), (new_j, m_j) = parity[case]

    assert r0["digest"] == r1["digest"]
    m_t = r0["metrics"]
    np.testing.assert_array_equal(m_t["viz_attn"], m_j["viz_attn"])
    keys = [k for k in m_j if k.startswith(("loss", "grad_norm"))]
    assert set(keys) <= set(m_t) and "loss_kl" in keys
    for k in keys:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(m_t[k], r1["metrics"][k], err_msg=k)

    # the control: averaging the rank-local losses misses the global ones
    for k in ("loss_kl", "loss_dur"):
        mean_local = (r0["local"][k] + r1["local"][k]) / WORLD
        assert abs(mean_local - m_j[k]) > 1e-4 * abs(m_j[k]) + 1e-6, k

    parts = [("gen", 2 * LR), ("disc", 0.0 if variant == "stft" else 2 * LR)]
    if use_dur_dis:
        parts.append(("dur", 0.0 if variant == "stft" else 2 * LR_P))
    for key, rule_lr in parts:
        names = set(r0["state"][key])
        grads = state_from_jax(new_j[f"{key}_opt"][1], names)
        params = state_from_jax(new_j[key], names)
        assert set(r0["grads"][key]) <= names
        for name, g_t in r0["grads"][key].items():
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(g_t, g_j, atol=g_tol, rtol=0, err_msg=name)
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, rule_lr, 0.0)
            assert np.all(np.abs(r0["state"][key][name] - p_j) <= p_tol), name
        for name in names - set(r0["grads"][key]):  # buffers: spectral norm's u
            u_j = params[name].numpy()
            assert np.all(np.abs(r0["state"][key][name] - u_j) <= 1e-6 + 1e-4 * np.abs(u_j)), \
                name


# four ranks of two: the even ranks' utterances long, the odd ranks' short
X_LENGTHS_4 = (11, 10, 6, 5, 11, 9, 7, 5)
SPEC_LENGTHS_4 = (24, 22, 14, 12, 23, 21, 15, 12)
F64_RTOL = 1e-9


def test_four_ranks_in_float64_take_the_one_process_step_on_the_global_batch(tmp_path):
    b = _batch(B=8)
    b["x_lengths"] = np.array(X_LENGTHS_4, np.int32)
    b["spec_lengths"] = np.array(SPEC_LENGTHS_4, np.int32)
    job = _job("mel", True, _weights("mel", True), b)
    job["cfg"].update(compute_dtype=torch.float64)
    for part in ("batch", "noise"):
        job[part] = {k: v.double() if v.is_floating_point() else v for k, v in job[part].items()}
    procs, outs = _spawn(tmp_path, torch_ddp_rank.step_rank, job, world=4)
    state, m1 = torch_ddp_rank._step(job, 0, 1, None)  # one process, meanwhile
    ranks = _join(procs, outs)

    assert len({r["digest"] for r in ranks}) == 1
    m4 = ranks[0]["metrics"]
    keys = [k for k in m1 if k.startswith(("loss", "grad_norm"))]
    assert "loss_kl" in keys and "loss_disc_p" in keys
    for k in keys:
        assert m4[k].dtype == np.float64, k
        np.testing.assert_allclose(m4[k], m1[k].numpy(), rtol=F64_RTOL, atol=0, err_msg=k)
    np.testing.assert_array_equal(np.concatenate([r["metrics"]["viz_attn"][None] for r in
                                                  ranks[:1]]), m1["viz_attn"][None].numpy())
    for key in ("gen", "disc", "dur"):
        for name, p in state[key].named_parameters():
            g1 = p.grad.numpy()
            assert g1.dtype == np.float64
            np.testing.assert_allclose(ranks[0]["grads"][key][name], g1, rtol=0,
                                       atol=F64_RTOL * float(np.abs(g1).max()),
                                       err_msg=f"{key}.{name}")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_loop.py's TINY corpus and config (train.epochs 1, a log
    every step, an eval and a save at the epoch's last step on two ranks) as
    a JSON file, the JAX config, and the two ranks' steps in the epoch."""
    tmp = tmp_path_factory.mktemp("ddp")
    train_scp, valid_scp = make_corpus(tmp)
    hj = make_hps(tmp, train_scp, valid_scp)
    cfg = hj.to_dict()
    hps = HParams(**cfg)
    steps = len(TL.BucketSampler(
        TL.TextAudioSpeakerDataset(hps.data.training_files, hps, load_spec=False).lengths,
        hps.train.batch_size, hps.train.bucket_boundaries, num_replicas=WORLD))
    assert steps >= 2
    cfg["train"].update(epochs=1, log_interval=1, eval_interval=steps)
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    return tmp, hj, cfg, steps


def _digests(text):
    return dict(re.findall(r"\[rank (\d)/2\] step \d+ parameter sha256 (\w+)", text))


def test_torchrun_trains_two_ranks_and_rank_0_alone_writes(corpus):
    tmp, hj, cfg, steps = corpus
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", str(WORLD), "-m", "vits_tpu_torch.train",
                        "-m", "ddp", "-d", "-c", str(tmp / "cfg.json"), "--device", "cpu"],
                       cwd=tmp, env=env, capture_output=True, text=True, timeout=JOIN_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout + r.stderr
    assert "backend gloo: 2 ranks on the cpu" in out
    digests = _digests(out)
    assert set(digests) == {"0", "1"} and digests["0"] == digests["1"]

    run_dir = tmp / "logs" / "ddp"
    files = set(os.listdir(run_dir))
    assert {f for f in files if f.endswith(".npz")} == {f"{p}_{steps}.npz" for p in "GDP"}
    events = [f for f in files if f.startswith("events")]
    assert len(events) == 1 and "train.log" in files and "config.json" in files
    log = (run_dir / "train.log").read_text()
    assert log.count("Total parameters of Generator") == 1
    assert len(re.findall(r"step 1 epoch 1 lr", log)) == 1
    assert "data parallel: 2 ranks, gloo, global batch 4" in log
    assert len(re.findall(rf"eval step {steps} mel_l1", log)) == 1
    assert f"the 2 replicas agree, parameter sha256 {digests['0']}" in log

    models = JL.build_models(hj, "mel", True)
    opts = JL.build_optimizers(hj, "mel", True)
    shapes = jax.eval_shape(lambda: JL.init_state(hj, *models, *opts))
    for prefix, key in (("G", "gen"), ("D", "disc"), ("P", "dur")):
        tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      {"model": shapes[key], "optimizer": shapes[f"{key}_opt"]})
        path = str(run_dir / f"{prefix}_{steps}.npz")
        with np.load(path) as z:
            got = {k: z[k].shape for k in z.files}
        for k, v in jck._flatten(tmpl).items():
            assert k.endswith("__empty__") or got.get(k) == v.shape, (prefix, k)
        loaded, step, epoch = jck.load_checkpoint(path, tmpl)
        assert (step, epoch) == (steps, 1) and int(loaded["optimizer"].count) == steps


def test_the_stft_cli_trains_two_ranks_and_resumes(corpus, tmp_path):
    """`train_stft.main` on two ranks for an epoch, then again: every rank
    resumes the epoch's checkpoints (RAdam state and u included), rank 0's
    state is broadcast, and the epoch is trained again; the ranks' digests
    are equal after each run."""
    tmp, _, _, steps = corpus
    procs, outs = _spawn(tmp_path, torch_ddp_rank.cli_rank, "vits_tpu_torch.train_stft",
                         ["-m", "ddp_stft", "-c", str(tmp / "cfg.json"), "--device", "cpu"],
                         str(tmp), MRD)
    r0, r1 = _join(procs, outs)
    assert [s for s, _ in r0] == [s for s, _ in r1] == [steps, 2 * steps]
    assert r0 == r1 and r0[0][1] != r0[1][1]
    run_dir = tmp / "logs" / "ddp_stft"
    files = set(os.listdir(run_dir))
    assert {f for f in files if f.endswith(".npz")} == \
        {f"{p}_{s}.npz" for p in "GD" for s in (steps, 2 * steps)}
    log = (run_dir / "train.log").read_text()
    assert log.count("Resumed G from") == log.count("Resumed D from") == 1
    # rank 0's: a TensorBoard file a run, or one JSONL log
    assert 1 <= len([f for f in files if f.startswith("events")]) <= 2


def test_one_process_with_world_size_1_is_unchanged(corpus, monkeypatch):
    """WORLD_SIZE=1 (torchrun --nproc_per_node 1) computes bit for bit what
    a run without the variable computes, with no process group. The runs'
    saves are recorded, not written (the full MPD's state is ~0.6 GB)."""
    tmp, _, cfg, _ = corpus
    saved = []
    monkeypatch.setattr(TL, "save_all", lambda hps, state, epoch: saved.append(state["step"]))
    digests = []
    for env in ({}, {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}):
        hps = HParams(**cfg)
        hps.train.eval_interval = 1000
        hps.model_dir = str(tmp / "logs" / f"one{len(digests)}")
        os.makedirs(hps.model_dir)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        seen = []
        state, steps = TL.run(hps, max_steps=2, device="cpu",
                              log_cb=lambda s, m: seen.append(torch.distributed.is_initialized()))
        assert steps == 2 and seen == [False, False]
        digests.append(dist.state_digest(state))
    assert digests[0] == digests[1] and saved == [2, 2]
