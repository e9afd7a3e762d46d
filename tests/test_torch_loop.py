"""The port's training runtime at TINY on the CPU (tests/test_loop.py's
synthetic corpus and `make_hps`, with the duration discriminator): `run`,
its checkpoints as the JAX package reads them, the summaries' tags against
`vits_tpu.train.loop.log_train_summaries`, eval, a resume through the CLI's
`main(args)` with `--device cpu`, and what `run` refuses.

The stft/MRD variant runs through the same `run` and its CLI twin
`vits_tpu_torch.train_stft`. The loop builds the full-width
MultiWaveSTFTDiscriminator, as the JAX loop does, whose 2048-point STFT and
176-sample wave receptive span need a segment of thousands of samples; at
TINY's 64-sample segment these tests give the loop `tiny_mrd_disc()`'s twin
instead (monkeypatched; the step reads the STFT resolutions from the
discriminator, so the TINY ones come with it), and the card runs the full
width (chip_smoke.py `[run_stft]`).

Tolerances: the summaries' scalars EQUAL the JAX function's on the same
metrics; checkpoint leaves EQUAL in key and shape to the JAX package's own
training state; losses and the eval mel L1 finite.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

import jax

from test_loop import make_corpus, make_hps
from test_torch_stft_train import tiny_mrd
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu.train import loop as JL
from vits_tpu.utils import checkpoint as jck
from vits_tpu.utils.tiny import TINY_RESOLUTIONS, tiny_mrd_disc

from vits_tpu_torch.config import HParams, get_hparams_from_dir
from vits_tpu_torch.train import loop as TL
from vits_tpu_torch.train.__main__ import main
from vits_tpu_torch.train_stft import main as main_stft
from vits_tpu_torch.utils import checkpoint as tck

NAME = "tiny"
STFT_STEPS = 4  # a log step at 2, an eval and a save at 4


def _tiny_mrd(mp):
    mp.setattr(TL, "MultiWaveSTFTDiscriminator", tiny_mrd)


class _FakeWriter:
    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, v, step):
        self.scalars[tag] = v

    def add_image(self, tag, img, step):
        self.images[tag] = img


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """Four steps of `run(device="cpu")` with -d into <tmp>/logs/tiny, every
    `log_train_summaries` call recorded."""
    tmp = tmp_path_factory.mktemp("loop")
    train_scp, valid_scp = make_corpus(tmp)
    hj = make_hps(tmp, train_scp, valid_scp)
    hps = HParams(**hj.to_dict())
    hps.model_dir = str(tmp / "logs" / NAME)
    os.makedirs(hps.model_dir)
    hps.use_dur_dis = True
    summaries, logged = [], []
    real = TL.log_train_summaries

    def record(writer, step, m, lr):
        out = real(writer, step, m, lr)
        summaries.append((step, m, lr, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "log_train_summaries", record)
        state, steps = TL.run(hps, max_steps=4, device="cpu",
                              log_cb=lambda s, m: logged.append((s, m)))
    return tmp, hj, hps, state, steps, summaries, logged


def _log(hps):
    with open(os.path.join(hps.model_dir, "train.log")) as f:
        return f.read()


def test_run_writes_checkpoints_logs_and_events(first_run):
    _, _, hps, state, steps, _, logged = first_run
    assert steps == 4 and state["step"] == 4
    assert [s for s, _ in logged] == [2, 4]
    for _, m in logged:
        assert all(math.isfinite(v) for v in m.values())
        assert {"loss_disc_p", "loss_gen_p", "grad_norm_p", "audio_sec_per_s",
                "input_stall_pct"} <= set(m)
    files = set(os.listdir(hps.model_dir))
    assert {"G_4.npz", "D_4.npz", "P_4.npz", "train.log", "githash"} - files <= {"githash"}
    assert any(f.startswith("events.out.tfevents") or f == "events.jsonl" for f in files)
    assert "Total parameters of Generator" in _log(hps)
    mel_l1 = re.findall(r"eval step 4 mel_l1 (\S+)", _log(hps))
    assert len(mel_l1) == 1 and math.isfinite(float(mel_l1[0]))


def test_summary_tags_equal_jax(first_run):
    """The scalars and image tags the loop emitted equal what the JAX
    package's function emits on the same host metrics."""
    _, _, _, _, _, summaries, _ = first_run
    assert [s for s, *_ in summaries] == [2, 4]
    for step, m, lr, (scalars, images) in summaries:
        s_j, i_j = JL.log_train_summaries(_FakeWriter(), step, m, lr)
        assert scalars == s_j and set(images) == set(i_j)
        assert {"loss/p/total", "loss/p/gen", "loss/p/0", "loss/p_r/0", "loss/p_g/0",
                "loss/d_r/0", "learning_rate"} <= set(scalars)
        assert not any(t.startswith("viz") or t.endswith("loss_gen") for t in scalars)
        for tag, img in images.items():
            assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8, tag


def test_the_jax_package_reads_every_leaf_of_the_runs_checkpoints(first_run):
    """G_4/D_4/P_4 hold every leaf of the JAX package's own training state
    at this config (built abstractly by its build_models and init_state),
    in its shape; `vits_tpu.utils.checkpoint.load_checkpoint` reads them."""
    _, hj, hps, *_ = first_run
    models = JL.build_models(hj, "mel", True)
    opts = JL.build_optimizers(hj, "mel", True)
    shapes = jax.eval_shape(lambda: JL.init_state(hj, *models, *opts))
    for prefix, key in (("G", "gen"), ("D", "disc"), ("P", "dur")):
        tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      {"model": shapes[key], "optimizer": shapes[f"{key}_opt"]})
        path = os.path.join(hps.model_dir, f"{prefix}_4.npz")
        with np.load(path) as z:
            files = {k: z[k].shape for k in z.files}
        for k, v in jck._flatten(tmpl).items():
            assert k.endswith("__empty__") or files.get(k) == v.shape, (prefix, k)
        loaded, step, epoch = jck.load_checkpoint(path, tmpl)
        assert (step, epoch) == (4, 1) and int(loaded["optimizer"].count) == 4


def test_the_cli_resumes_the_run(first_run, monkeypatch):
    """`python -m vits_tpu_torch.train -m tiny -d -c <config> --device cpu`,
    through `main(args)` in the run's parent directory, resumes the four-step
    run at step 4 in epoch 1 at the same lr and trains the rest of epoch 1
    (the config's last)."""
    tmp, _, hps, *_ = first_run
    cfg = hps.to_dict()
    for k in ("model_dir", "use_dur_dis"):
        cfg.pop(k)
    cfg["train"]["epochs"] = 1
    (tmp / "cli.json").write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp)
    state, steps = main(["-m", NAME, "-d", "-c", str(tmp / "cli.json"), "--device", "cpu"])
    per_epoch = len(TL.BucketSampler(
        TL.TextAudioSpeakerDataset(hps.data.training_files, hps, load_spec=False).lengths,
        hps.train.batch_size, hps.train.bucket_boundaries))
    assert steps == state["step"] == 4 + per_epoch and per_epoch > 2
    log = _log(hps)
    assert "Resumed G from" in log and "Resumed P from" in log
    assert re.search(r"step 6 epoch 1 lr 0\.0002 \|", log)
    g = tck.latest_checkpoint_path(hps.model_dir)
    tree, step, epoch = tck.read_checkpoint(g)
    assert os.path.basename(g) == f"G_{steps}.npz" and (step, epoch) == (steps, 1)
    assert int(tree["optimizer"]["3"]["0"]["0"]) == steps
    assert float(tree["optimizer"]["1"]["learning_rate"]) == float(np.float32(2e-4))
    snap = get_hparams_from_dir(hps.model_dir)
    assert snap.model_dir == hps.model_dir and snap.train.epochs == 1
    assert snap.to_dict()["data"] == cfg["data"] and len(snap) == len(cfg) + 1
    assert len(list(snap.values())) == len(snap) and snap.train in snap.values()


@pytest.fixture(scope="module")
def stft_run(first_run):
    """STFT_STEPS steps of `run(variant="stft", device="cpu")` with -d into
    <tmp>/logs/tiny_stft on the first run's corpus, every
    `log_train_summaries` call recorded."""
    tmp, hj, hps0, *_ = first_run
    hps = HParams(**hps0.to_dict())
    hps.model_dir = str(tmp / "logs" / "tiny_stft")
    os.makedirs(hps.model_dir)
    summaries, logged = [], []
    real = TL.log_train_summaries

    def record(writer, step, m, lr):
        out = real(writer, step, m, lr)
        summaries.append((step, m, lr, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        _tiny_mrd(mp)
        mp.setattr(TL, "log_train_summaries", record)
        state, steps = TL.run(hps, variant="stft", max_steps=STFT_STEPS, device="cpu",
                              log_cb=lambda s, m: logged.append((s, m)))
    return tmp, hj, hps, state, steps, summaries, logged


def test_run_trains_the_stft_variant(stft_run):
    """The stft run's losses, summaries (the JAX function's scalars on the
    same metrics, no mel-loss tags, no full-mel image), checkpoints with
    RAdam state and u (every leaf of the JAX package's own stft training
    state at this config, read by its loader) and the logged discriminator
    count (the JAX loop's)."""
    _, hj, hps, state, steps, summaries, logged = stft_run
    assert steps == state["step"] == STFT_STEPS
    assert isinstance(state["disc_opt"], torch.optim.RAdam)
    assert isinstance(state["dur_opt"], torch.optim.RAdam)
    assert state["disc"].resolutions == TINY_RESOLUTIONS  # the magnitudes the step formed
    assert [s for s, _ in logged] == [2, 4]
    for _, m in logged:
        assert all(math.isfinite(v) for v in m.values())
        assert {"loss_stft", "loss_disc_p", "loss_gen_p"} <= set(m)
        assert not {"loss_mel", "loss_fm"} & set(m)
    for step, m, lr, (scalars, images) in summaries:
        s_j, i_j = JL.log_train_summaries(_FakeWriter(), step, m, lr)
        assert scalars == s_j and set(images) == set(i_j)
        assert "loss/g/stft" in scalars and "loss/g/mel" not in scalars
        assert set(images) == {"slice/mel_org", "slice/mel_gen", "all/attn"}
    log = _log(hps)
    assert re.search(r"eval step 4 mel_l1 \S+", log)
    disc_j = tiny_mrd_disc()
    models = JL.build_models(hj, "stft", True)
    opts = JL.build_optimizers(hj, "stft", True)
    shapes = jax.eval_shape(lambda: JL.init_state(hj, models[0], disc_j, models[2], *opts))
    n_disc = JL.count_params(shapes["disc"], exclude=())
    assert f"Total parameters of Discriminator: {n_disc}" in log
    for prefix, key in (("G", "gen"), ("D", "disc"), ("P", "dur")):
        tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      {"model": shapes[key], "optimizer": shapes[f"{key}_opt"]})
        path = os.path.join(hps.model_dir, f"{prefix}_{STFT_STEPS}.npz")
        with np.load(path) as z:
            files = {k: z[k].shape for k in z.files}
        for k, v in jck._flatten(tmpl).items():
            assert k.endswith("__empty__") or files.get(k) == v.shape, (prefix, k)
        loaded, step, epoch = jck.load_checkpoint(path, tmpl)
        assert (step, epoch) == (STFT_STEPS, 1)
        assert int(loaded["optimizer"].count) == STFT_STEPS
    d_tree, _, _ = tck.read_checkpoint(os.path.join(hps.model_dir, f"D_{STFT_STEPS}.npz"))
    u = d_tree["model"]["mwd"]["discriminators"]["0"]["convs"]["1"]["u"]
    torch.testing.assert_close(torch.from_numpy(u),
                               state["disc"].mwd.discriminators["0"].convs["1"].weight_u,
                               atol=0, rtol=0)


def test_the_stft_cli_trains_one_step(stft_run, monkeypatch):
    """`python -m vits_tpu_torch.train_stft -m <name> -d -c <config> --device
    cpu`, through `main(args)`, from scratch on a one-batch corpus for one
    epoch: one step, its checkpoints written."""
    tmp, _, hps, *_ = stft_run
    ds = TL.TextAudioSpeakerDataset(hps.data.training_files, hps, load_spec=False)
    sampler = TL.BucketSampler(ds.lengths, 2, hps.train.bucket_boundaries)
    pair = next(b[:2] for b in sampler.buckets if len(b) >= 2)
    (tmp / "one.scp").write_text("\n".join("|".join(map(str, ds.items[i][:4])) for i in pair))
    cfg = hps.to_dict()
    cfg.pop("model_dir")
    cfg["data"]["training_files"] = str(tmp / "one.scp")
    cfg["train"]["epochs"] = 1
    (tmp / "cli_stft.json").write_text(json.dumps(cfg))
    _tiny_mrd(monkeypatch)
    monkeypatch.chdir(tmp)
    state, steps = main_stft(["-m", "cli_stft", "-d", "-c", str(tmp / "cli_stft.json"),
                              "--device", "cpu"])
    assert steps == state["step"] == 1
    assert isinstance(state["disc_opt"], torch.optim.RAdam)
    files = set(os.listdir(tmp / "logs" / "cli_stft"))
    assert {"G_1.npz", "D_1.npz", "P_1.npz", "config.json"} <= files


def test_run_refuses_the_stft_variant_and_several_processes(first_run, monkeypatch):
    """`run` refuses a variant it does not know (the stft one it now trains,
    test_run_trains_the_stft_variant) and several processes."""
    _, _, hps, *_ = first_run
    with pytest.raises(ValueError, match="variant 'wave'"):
        TL.run(hps, variant="wave", device="cpu")
    with pytest.raises(ValueError, match="variant 'wave'"):
        TL.build_models(hps, "wave")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        TL.run(hps, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        TL.run(hps, variant="stft", device="cpu")
