"""One rank of tests/test_torch_ddp.py, run in a spawned process of its own
with torch and the port only (no JAX): the process group over gloo from a
`file://` store, one intra-op thread, and the rank's work; its results are
pickled to `out`."""

import os
import pickle

import torch
import torch.distributed as tdist

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator
from vits_tpu_torch.models.synthesizer import DurationDiscriminator, Synthesizer
from vits_tpu_torch.parallel import dist
from vits_tpu_torch.train import loop
from vits_tpu_torch.train.optim import Optimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step


def _join(rank, world, store):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                             world_size=world)


def _models(job):
    """The job's models and optimizers; in float64 where the job's step
    config asks for float64 masters."""
    synth = params_from_jax(job["gen"], Synthesizer(**job["synth"], weight_norm=True)).train()
    if job["cfg"]["variant"] == "stft":
        disc, kind = MultiWaveSTFTDiscriminator(**job["mrd"]), "radam"
    else:
        disc, kind = MultiPeriodDiscriminator(periods=(2, 3)), "adamw"
    state = {"gen": synth, "disc": params_from_jax(job["disc"], disc).train(),
             "gen_opt": Optimizer((0.8, 0.99), 1e-9, 0.01).init(synth.parameters()),
             "step": 0, "rng": None}
    state["disc_opt"] = Optimizer((0.8, 0.99), 1e-9, 0.0, kind).init(state["disc"].parameters())
    if job["cfg"]["use_dur_dis"]:
        dur = params_from_jax(job["dur"], DurationDiscriminator(*job["dur_args"])).train()
        state.update(dur=dur,
                     dur_opt=Optimizer((0.8, 0.99), 1e-9, 0.0, kind).init(dur.parameters()))
    dtype = torch.promote_types(job["cfg"].get("compute_dtype", torch.float32), torch.float32)
    for key in ("gen", "disc", "dur"):
        if key in state:
            state[key].to(dtype)
    return state


def _half(tensors, rank, world):
    return {k: v.chunk(world)[rank] for k, v in tensors.items()}


def _step(job, rank, world, group):
    state = _models(job)
    step = make_train_step(TrainStepConfig(**job["cfg"]), group)
    with torch.backends.mkldnn.flags(enabled=False):
        state, m = step(state, _half(job["batch"], rank, world),
                        _half(job["noise"], rank, world), *job["lrs"])
    return state, m


def step_rank(rank, world, store, job, out):
    """One step of the `world`-rank port on this rank's part of the batch
    and the noise, and, as the control, the same step in one process on the
    same part (rank-local normalisers). Writes the summed metrics, the control's
    metrics, every summed gradient, the updated parameters and buffers."""
    _join(rank, world, store)
    try:
        _, local = _step(job, rank, world, None)
        state, m = _step(job, rank, world, tdist.group.WORLD)
        shares = dist.allreduce_metrics({k: v for k, v in m.items() if k.startswith("loss")},
                                        tdist.group.WORLD)
        res = {"metrics": {k: v.numpy() for k, v in {**m, **shares}.items()},
               "local": {k: v.numpy() for k, v in local.items()},
               "grads": {}, "state": {}, "digest": dist.state_digest(state)}
        for key in ("gen", "disc", "dur"):
            if key in state:
                res["grads"][key] = {n: p.grad.numpy() for n, p in
                                     state[key].named_parameters()}
                res["state"][key] = {n: t.numpy() for n, t in state[key].state_dict().items()}
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        tdist.destroy_process_group()


def cli_rank(rank, world, store, module, argv, cwd, mrd, out):
    """`module.main(argv)` (a training CLI) twice, the second resuming the
    first's checkpoints, as rank `rank` of a group made here, in `cwd`, with
    the TINY MRD (`mrd`, its kwargs) in place of the full-width one. Writes
    each run's steps and state digest."""
    _join(rank, world, store)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    os.chdir(cwd)
    loop.MultiWaveSTFTDiscriminator = lambda: MultiWaveSTFTDiscriminator(**mrd)
    main = __import__(module, fromlist=["main"]).main
    try:
        runs = []
        for _ in range(2):
            state, steps = main(argv)
            assert tdist.is_initialized()  # the run leaves the group it did not make
            runs.append((steps, dist.state_digest(state)))
        with open(out, "wb") as f:
            pickle.dump(runs, f)
    finally:
        tdist.destroy_process_group()
