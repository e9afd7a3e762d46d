"""Driver "train": the configured GAN training step as `train/loop.py`'s
`_run` runs it, without its logging, evaluation and saves.

Set-up: a corpus written from the seed into the run's temporary directory
(`traffic.write_corpus`, every length bucket a whole number of batches); the
program's dataset, `BucketSampler` over `DEFAULT_BOUNDARIES`, `Prefetcher`
(pinned, placed on the card, compact batches when the step runs in bf16),
models and optimizer states from `loop.build_models` / `build_optimizers` /
`init_state` (seeded from the run's seed), and `make_train_step` of the
config. The first three steps go through the window's own feed and call and
are recorded for the check (losses, the first gradient as AdamW's first
moment holds it, the parameters' change over the three); steps then go on
until every bucket shape has run once. Window: steps back to back; after its
seconds the card is synchronised and the window closes. A step's audio is
its batch's wav lengths.

After the window the reference (the frozen copy of the models, step, data
pipeline and AdamW) rebuilds the first three batches from the corpus files,
initialises its models from the same seed, draws the same noise, runs the
three steps, and the gaps are compared with their limits."""

from __future__ import annotations

import functools
import gc
import json
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import torch

from benchmark.harness import common, trace
from benchmark.harness.traffic import hps_of, write_corpus

LOSS_KEYS = ("loss_g_total", "loss_disc", "loss_mel", "loss_fm", "loss_gen", "loss_dur",
             "loss_kl", "loss_kl_q")
CHECK_STEPS = 3


def init_seed(seed: int) -> int:
    return int(seed) % (2 ** 62)


def leaf_norms(models: Dict[str, torch.nn.Module], tensors=None) -> Dict[str, float]:
    """{model.param: L2 norm} of `tensors` ({name: tensor}) or of the
    parameters themselves."""
    out = {}
    for key, m in models.items():
        for n, p in m.named_parameters():
            t = p if tensors is None else tensors[f"{key}.{n}"]
            out[f"{key}.{n}"] = t
    names = list(out)
    norms = torch.stack([torch.linalg.vector_norm(out[n].detach().float()) for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def first_grads(models, opts) -> Dict[str, torch.Tensor]:
    """The first step's gradient of every parameter, from AdamW's first
    moment after one step: exp_avg = (1 - beta1) g."""
    out = {}
    for key, m in models.items():
        opt = opts[key]
        b1 = opt.param_groups[0]["betas"][0]
        for n, p in m.named_parameters():
            st = opt.state.get(p, {})
            out[f"{key}.{n}"] = st["exp_avg"] / (1.0 - b1) if "exp_avg" in st \
                else torch.zeros_like(p)
    return out


def snapshot(models) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p.detach().clone() for k, m in models.items()
            for n, p in m.named_parameters()}


def record_steps(models, opts, step_call, n: int) -> Dict:
    """Run n steps through `step_call`, recording what the check compares."""
    before = snapshot(models)
    losses = []
    grads = None
    for i in range(n):
        metrics = step_call()
        losses.append({k: float(metrics[k]) for k in LOSS_KEYS if k in metrics})
        if i == 0:
            grads = leaf_norms(models, first_grads(models, opts))
    delta = {f"{key}.{n_}": p.detach() - before[f"{key}.{n_}"]
             for key, m in models.items() for n_, p in m.named_parameters()}
    upd = leaf_norms(models, delta)
    del before, delta
    return {"losses": losses, "grads": grads, "update": upd}


def corpus_and_hps(cell: Dict, seed: int, workdir: str) -> Dict:
    cfg, tf = cell["config_file"], cell["traffic_file"]
    hps_dict = common.hparams(cfg)
    lines = write_corpus(os.path.join(workdir, "corpus"), tf["corpus"], hps_dict["data"],
                         seed, hps_dict["train"]["batch_size"] * int(tf.get("ranks", 1)))
    scp = os.path.join(workdir, "train.scp")
    with open(scp, "w") as f:
        f.write("\n".join(lines) + "\n")
    hps_dict["data"]["training_files"] = scp
    hps_dict["train"]["seed"] = init_seed(seed)
    return hps_dict


def run(cell: Dict, args, clock, dev) -> tuple:
    tf = cell["traffic_file"]
    world = int(tf.get("ranks", 1))
    workdir = tempfile.mkdtemp(prefix="bench-train-")
    try:
        hps_dict = corpus_and_hps(cell, args.seed, workdir)
        if world == 1:
            result, recorded, steps, window_s = run_rank(cell, args, clock, dev, hps_dict)
            exits = []
        else:
            with open(os.path.join(workdir, "hps.json"), "w") as f:
                json.dump(hps_dict, f)
            with open(os.path.join(workdir, "cell.json"), "w") as f:
                json.dump({k: cell[k] for k in ("name", "chips", "config_file", "traffic_file",
                                                "per_layer")}, f)
            port = free_port()
            procs = [spawn_rank(r, world, port, workdir, args) for r in range(1, world)]
            try:
                result, recorded, steps, window_s = run_rank(
                    cell, args, clock, dev, hps_dict, (0, world, port))
            finally:
                exits = [wait_rank(p) for p in procs]
        ref = reference_steps(hps_dict, dev, CHECK_STEPS, world=world)
        readings = compare_steps(recorded, ref)
        common.note(f"{steps} steps in {window_s:.3f} s; worst parts of the check: "
                    f"{readings['worst']}")
        limits = tf["check"]["limits"]
        checks = [common.check(k, readings[k], limits[k])
                  for k in ("loss_gap", "grad_gap", "update_gap")]
        if world > 1:
            checks.append(common.check("rank_exit_codes",
                                       max(abs(c if c is not None else 255) for c in exits), 0))
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def spawn_rank(rank: int, world: int, port: int, workdir: str, args):
    """Rank `rank` of the data-parallel run as a process of its own (this
    module's entry, `rank_main`); its output goes to a log in the run's
    directory."""
    import subprocess
    import sys
    log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
    cmd = [sys.executable, "-m", "benchmark.harness.train", "--rank", str(rank),
           "--world", str(world), "--workdir", workdir, "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
    proc = subprocess.Popen(cmd, cwd=common.ROOT, stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, **_rank_env(rank, world, port)})
    proc.log = log
    return proc


def wait_rank(proc, timeout: float = 300.0):
    """The rank's exit code; a rank still running after `timeout` is killed
    (None)."""
    import subprocess
    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        code = None
    proc.log.close()
    if code:
        with open(proc.log.name) as f:
            common.note(f"rank log {proc.log.name}:\n" + f.read()[-4000:])
    return code


def run_rank(cell, args, clock, dev, hps_dict, rank_info=None):
    """One rank's set-up, check steps, warm-up and window ((0, 1) without
    `rank_info`, else (rank, world, port)). Returns, on rank 0, (result,
    recorded check steps, steps in the window, window seconds)."""
    import torch.distributed as tdist
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.parallel import dist
    from vits_tpu_torch.train.data import (DEFAULT_BOUNDARIES, BucketSampler, Prefetcher,
                                           TextAudioSpeakerDataset, pin_batch, place_batch)
    from vits_tpu_torch.train.loop import (align_noise_at, build_models, build_optimizers,
                                           init_state)
    from vits_tpu_torch.train.optim import exponential_lr
    from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

    tf = cell["traffic_file"]
    traced = bool(args.trace)
    rank, world, port = rank_info or (0, 1, 0)
    group = ctl = None
    if world > 1:
        os.environ.update(_rank_env(rank, world, port))
        info = dist.init_distributed(dev.type)
        dev, group = info.device, info.group
        ctl = tdist.new_group(backend="gloo")
    hps = HParams(**hps_dict)
    t, d = hps.train, hps.data
    on_cuda = dev.type == "cuda"
    dataset = TextAudioSpeakerDataset(d.training_files, hps, load_spec=False)
    sampler = BucketSampler(dataset.lengths, t.batch_size, list(DEFAULT_BOUNDARIES),
                            num_replicas=world, rank=rank)
    prefetcher = Prefetcher(
        dataset, sampler, workers=int(getattr(t, "prefetch_workers", 8)),
        depth=int(getattr(t, "prefetch_depth", 2)),
        compact=bool(getattr(t, "compact_batch", getattr(t, "bf16_run", False))),
        transform=pin_batch if on_cuda else None,
        place=functools.partial(place_batch, device=dev) if on_cuda else None,
        place_depth=int(getattr(t, "prefetch_device_depth", 2)))
    synth, disc, _ = build_models(hps)
    gen_opt, disc_opt, _ = build_optimizers(hps)
    state = init_state(hps, synth, disc, None, gen_opt, disc_opt, None, device=dev, rank=rank)
    dist.broadcast_state(state, group)
    step_fn = make_train_step(TrainStepConfig.from_hps(hps), group)
    noise_gen = torch.Generator(device=dev).manual_seed(dist.rank_seed(t.seed + 17, rank))
    batches = prefetcher.stream(1, t.epochs)
    sr, hop, fl = d.sampling_rate, d.hop_length, d.filter_length
    ctx = {"step": 0, "epoch": 1, "lr": exponential_lr(t.learning_rate, t.lr_decay, 1),
           "wait": 0.0, "audio": 0.0, "shapes": [], "mas": []}

    def one_step():
        t_fetch = time.perf_counter()
        with trace.span("next_batch", traced):
            epoch, batch = next(batches)
        ctx["wait"] += time.perf_counter() - t_fetch
        if epoch != ctx["epoch"]:
            ctx["epoch"] = epoch
            ctx["lr"] = exponential_lr(t.learning_rate, t.lr_decay, epoch)
        ctx["audio"] += float(batch.pop("wav_lengths").sum()) / sr
        B, T_x = batch["x"].shape[0], batch["x"].shape[1]
        T_y = (batch["wav"].shape[1] - fl) // hop
        ctx["shapes"].append((B, T_x, T_y))
        if traced:
            ctx["mas"].append((batch["spec_lengths"].to("cpu", non_blocking=True),
                               batch["x_lengths"].to("cpu", non_blocking=True), T_y, T_x))
        with trace.span("step", traced):
            noise = synth.draw_noise(B, T_x, T_y, noise_gen)
            _, metrics = step_fn(state, batch, noise, ctx["lr"], ctx["lr"],
                                 align_noise_at(hps, ctx["step"]))
        ctx["step"] += 1
        return metrics

    def agree(value: float, op) -> float:
        """value reduced over the ranks (on the host, through gloo)."""
        if world == 1:
            return value
        v = torch.tensor([value], dtype=torch.float64)
        tdist.all_reduce(v, op, group=ctl)
        return float(v[0])

    models = {"gen": state["gen"], "disc": state["disc"]}
    opts = {"gen": state["gen_opt"], "disc": state["disc_opt"]}
    recorded = record_steps(models, opts, one_step, CHECK_STEPS)
    n_shapes = len(sampler.buckets)
    while len(set(ctx["shapes"])) < n_shapes:
        one_step()
    if on_cuda:
        torch.cuda.synchronize()
    agree(0.0, tdist.ReduceOp.SUM)  # every rank set up
    setup_s = clock()

    seconds = min(args.seconds, tf["trace_seconds"]) if traced else args.seconds
    record: Dict = {}
    ctx.update(wait=0.0, audio=0.0, shapes=[], mas=[])
    with trace.profiled(traced, record):
        t_start = time.perf_counter()
        t_end = t_start + seconds
        steps = 0
        marks = [t_start]
        # rank 0's clock closes the window: the others learn it at each step
        while agree(float(rank == 0 and time.perf_counter() < t_end), tdist.ReduceOp.MAX):
            one_step()
            steps += 1
            marks.append(time.perf_counter())
        if on_cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    host = sorted(b - a for a, b in zip(marks, marks[1:]))
    if host and rank == 0:
        common.note(f"host seconds a step: min {host[0]:.4f}, median {host[len(host) // 2]:.4f}, "
                    f"max {host[-1]:.4f}; input wait {ctx['wait']:.4f} s")
    batches.close()
    audio = agree(ctx["audio"], tdist.ReduceOp.SUM)
    peak = agree(float(peak), tdist.ReduceOp.MAX)
    busy = agree(record.get("busy_s", 0.0), tdist.ReduceOp.SUM) / world
    result = {"attempted": steps * world, "failed": 0,
              "device": common.device_info(cell["chips"], peak, dev)}
    if not traced:
        result["metrics"] = {
            "train_audio_s_per_s": common.metric(audio / window_s, "audio-s/s"),
            "setup_s": common.metric(setup_s, "s")}
    else:
        from benchmark.reference.step import TrainStepConfig as RefCfg
        rec = {**record, "cell": cell, "hps": hps_of(hps_dict), "train_work": ctx["shapes"],
               "step_cfg": RefCfg.from_hps(hps_of(hps_dict)), "input_wait_s": ctx["wait"],
               "mas_calls": [(a, b, ty, tx) for a, b, ty, tx in ctx["mas"]]}
        result["metrics"] = common.per_layer(cell, rec)
        result["device"].update(busy_s=busy, window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    del state, synth, disc, models, opts, step_fn, batches, prefetcher
    if world > 1:
        dist.shutdown()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    return result, recorded, steps, window_s


def reference_steps(hps_dict: Dict, dev, n: int, fault=None, world: int = 1) -> Dict:
    """The frozen reference's first n steps from the seed in hps_dict: the
    same corpus and batches (its copy of the dataset, sampler and collate),
    initial weights, noise and dropout generators. With `world` > 1 the
    ranks are threads of this process (`reference.dist.ThreadGroup`), each
    with its replica, on card `rank` where there are enough cards; rank 0's
    record is returned."""
    import copy
    import threading
    from benchmark.reference import core
    from benchmark.reference.discriminators import MultiPeriodDiscriminator
    from benchmark.reference.dist import ThreadGroup
    from benchmark.reference.synthesizer import Synthesizer

    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    hps = hps_of(hps_dict)
    t = hps.train
    synth = Synthesizer.from_hps(hps, train=True)
    disc = MultiPeriodDiscriminator(getattr(hps.model, "use_spectral_norm", False))
    gen = torch.Generator().manual_seed(t.seed)
    core.init_weights(synth, gen)
    core.init_weights(disc, gen)
    if world == 1:
        return _reference_rank(hps, synth, disc, dev, n, fault, 0, 1, None)
    group = ThreadGroup(world)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    out: Dict = {}
    errors: List = []

    def rank_thread(r):
        try:
            group.enter(r)
            d = torch.device("cuda", r) if cards >= world else dev
            if d.type == "cuda":
                torch.cuda.set_device(d)
            rec = _reference_rank(hps, copy.deepcopy(synth), copy.deepcopy(disc), d, n, fault,
                                  r, world, group)
            if r == 0:
                out.update(rec)
        except BaseException as e:  # reported below, after every thread has ended
            errors.append(e)
            group._barrier.abort()

    threads = [threading.Thread(target=rank_thread, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _reference_rank(hps, synth, disc, dev, n, fault, rank, world, group) -> Dict:
    from benchmark.reference.data import (DEFAULT_BOUNDARIES, BucketSampler, Prefetcher,
                                          TextAudioSpeakerDataset)
    from benchmark.reference.optim import Optimizer, exponential_lr
    from benchmark.reference.step import TrainStepConfig, make_train_step

    t, d = hps.train, hps.data
    dataset = TextAudioSpeakerDataset(d.training_files, hps, load_spec=False)
    sampler = BucketSampler(dataset.lengths, t.batch_size, list(DEFAULT_BOUNDARIES),
                            num_replicas=world, rank=rank)
    pf = Prefetcher(dataset, sampler, workers=2, compact=bool(getattr(t, "bf16_run", False)))
    feed = pf.stream(1, t.epochs)
    synth.to(dev).train()
    disc.to(dev).train()
    betas = tuple(t.betas)
    stride = 1_000_003  # the port's seed stride between ranks' generators
    state = {"gen": synth, "disc": disc, "step": 0,
             "gen_opt": Optimizer(betas, t.eps, t.weight_decay).init(synth.parameters()),
             "disc_opt": Optimizer(betas, t.eps, 0.0).init(disc.parameters()),
             "rng": torch.Generator(device=dev).manual_seed(t.seed + 1 + stride * rank)}
    step_fn = make_train_step(TrainStepConfig.from_hps(hps), group)
    noise_gen = torch.Generator(device=dev).manual_seed(t.seed + 17 + stride * rank)
    lr = exponential_lr(t.learning_rate, t.lr_decay, 1)

    def one_step():
        _, batch = next(feed)
        batch = {k: v.to(dev) for k, v in batch.items() if k != "wav_lengths"}
        if fault:
            batch = fault(batch)
        B, T_x = batch["x"].shape[0], batch["x"].shape[1]
        T_y = (batch["wav"].shape[1] - d.filter_length) // d.hop_length
        noise = synth.draw_noise(B, T_x, T_y, noise_gen)
        a = t.align_noise - t.align_noise_decay * state["step"]
        _, metrics = step_fn(state, batch, noise, lr, lr, max(a, t.align_noise_min))
        return metrics

    models = {"gen": synth, "disc": disc}
    out = record_steps(models, {"gen": state["gen_opt"], "disc": state["disc_opt"]},
                       one_step, n)
    feed.close()
    return out


def _gap(p: float, r: float, scale: float) -> float:
    g = abs(p - r) / scale
    return g if g == g else float("inf")


def compare_steps(prog: Dict, ref: Dict) -> Dict:
    """loss_gap: the largest relative gap of a step's loss (over the three
    steps and the loss terms); grad_gap and update_gap: the worst leaf's gap
    between the program's norm and the reference's, over the larger of the
    reference leaf's norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    update_gap (they move by Adam's round-off alone). "worst" names the
    term or leaf of each."""
    losses = {f"step{i + 1}.{k}": _gap(lp.get(k, float("nan")), r, max(abs(r), 1e-6))
              for i, (lp, lr_) in enumerate(zip(prog["losses"], ref["losses"]))
              for k, r in lr_.items()}
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses["steps"] = float("inf")

    def leaves(p: Dict, r: Dict, keep) -> Dict:
        med = statistics.median(r.values())
        return {k: _gap(p.get(k, float("nan")), r[k], max(r[k], med)) for k in r if keep(k)}

    g_med = statistics.median(ref["grads"].values())
    parts = {"loss_gap": losses,
             "grad_gap": leaves(prog["grads"], ref["grads"], lambda k: True),
             "update_gap": leaves(prog["update"], ref["update"],
                                  lambda k: ref["grads"][k] >= 1e-3 * g_med)}
    out = {k: (max(v.values()) if v else float("inf")) for k, v in parts.items()}
    out["worst"] = {k: sorted(v.items(), key=lambda kv: -kv[1])[:3] for k, v in parts.items()}
    return out


def rank_main(argv=None) -> int:
    """A data-parallel rank other than 0, started by `spawn_rank`."""
    import argparse
    p = argparse.ArgumentParser()
    for k in ("--rank", "--world", "--seed", "--trace"):
        p.add_argument(k, type=int, required=True)
    for k in ("--workdir", "--workload"):
        p.add_argument(k, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    common.prepare_environment()
    with open(os.path.join(args.workdir, "cell.json")) as f:
        cell = json.load(f)
    with open(os.path.join(args.workdir, "hps.json")) as f:
        hps_dict = json.load(f)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    run_rank(cell, args, common.Clock(), dev, hps_dict, (args.rank, args.world,
                                                        int(os.environ["MASTER_PORT"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(rank_main())
