"""Graft entry points (counterpart of the JAX package's __graft_entry__.py):
`entry()`, the base config's full training forward, and
`dryrun_multichip(n)`, one data-parallel step of each variant and one
tensor-parallel decode on n ranks at the TINY config."""

from __future__ import annotations

import multiprocessing
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as tdist

JOIN_S = 600  # seconds each dry-run rank may take


def _tiny_cfg():
    return dict(
        text_channels=16, spec_channels=33, segment_size=8,
        inter_channels=8, hidden_channels=16, filter_channels=24,
        n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.1,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        upsample_rates=(4, 2), upsample_initial_channel=64,
        upsample_kernel_sizes=(8, 4), resblock="2", ffn="FFN2",
        kernel_size_q=5, n_layers_q=3, hidden_size_d=16, kernel_size_d=5,
        p_dropout_d=0.5, act_func_d="ReLU", dilation_rate=(1, 1), n_flows=2,
        n_speakers=8, gin_channels=16,
    )


def entry(device=None):
    """(fn, example_args): the full training-graph forward of the flagship
    (configs/base.json) synthesizer, seeded random weights with weight norm,
    in training mode, on `device` (`cuda` unless "cpu"), at (B 2, T_x 48,
    T_y 192). fn returns (y_hat, l_length, z_p). Its alignment search is
    `ops.mas.maximum_path` (K2 on the card; the JAX entry uses the scan)."""
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.device import resolve_device
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.nn.core import init_weights

    dev = resolve_device(device)
    hps = get_hparams_from_file(default_config_path("base"))
    synth = init_weights(Synthesizer.from_hps(hps, train=True), torch.Generator().manual_seed(0))
    synth = synth.to(dev).train()

    B, T_x, T_y = 2, 48, 192
    rng = np.random.RandomState(0)

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    example_args = (
        put(rng.randn(B, T_x, hps.data.text_channels).astype(np.float32)),
        put([T_x, T_x - 5], torch.int32),
        put(np.abs(rng.randn(B, T_y, hps.data.filter_length // 2 + 1)).astype(np.float32)),
        put([T_y, T_y - 17], torch.int32),
        put(rng.randn(B, 1024).astype(np.float32)),
        put([1, 2], torch.long),
        synth.draw_noise(B, T_x, T_y, torch.Generator(device=dev).manual_seed(1)),
        torch.Generator(device=dev).manual_seed(2),
    )

    def fn(x, x_lengths, spec, spec_lengths, emo, sid, noise, rng):
        out = synth.forward(x, x_lengths, spec, spec_lengths, emo, sid, noise,
                            align_noise=0.01, rng=rng)
        return out["y_hat"], out["l_length"], out["z_p"]

    return fn, example_args


def dryrun_rank(info, n_devices: int) -> Dict:
    """One rank's part of `dryrun_multichip` in a process group of
    `n_devices` ranks (`info`: `parallel.dist.DistInfo`): the TINY mel/MPD
    step and the TINY stft/MRD step over the group, this rank feeding its
    own utterance of the global batch; at n_devices >= 2 one `infer_p2` with
    the decoder split over the model axis of a (n // 2, 2) mesh
    (min_channels 32). Rank 0 prints the lines. Returns this rank's numbers,
    with every K2 launch's inputs and path on the host (`mas.recorded`;
    none on the CPU, where MAS takes the plain search)."""
    from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.ops.seq import infer_path
    from vits_tpu_torch.parallel import dist
    from vits_tpu_torch.parallel.mesh import make_mesh, make_tp_infer
    from vits_tpu_torch.train.optim import Optimizer
    from vits_tpu_torch.train.step import make_train_step
    from vits_tpu_torch.utils.tiny import init_gan_state, tiny_mrd_disc, tiny_step_config

    n, dev, group = n_devices, info.device, info.group
    say = print if info.rank == 0 else (lambda *a, **k: None)
    cfg_model = _tiny_cfg()
    gen_opt = Optimizer((0.8, 0.99), 1e-9, 0.01)

    B, T_x, T_y, HOP = n, 11, 24, 8
    rng = np.random.RandomState(0)
    batch = {
        "x": rng.randn(B, T_x, 16).astype(np.float32),
        "x_lengths": np.array([T_x - (i % 4) for i in range(B)], np.int32),
        "spec": np.abs(rng.randn(B, T_y, 33)).astype(np.float32),
        "spec_lengths": np.array([T_y - (i % 3) * 3 for i in range(B)], np.int32),
        "wav": rng.uniform(-0.5, 0.5, (B, T_y * HOP)).astype(np.float32),
        "emo": rng.randn(B, 1024).astype(np.float32),
        "sid": np.array([i % 8 for i in range(B)], np.int64),
    }
    local = {k: torch.from_numpy(v[info.rank:info.rank + 1]).to(dev) for k, v in batch.items()}
    noise_gen = torch.Generator(device=dev).manual_seed(dist.rank_seed(1, info.rank))
    out = {"rank": info.rank, "device": str(dev), "backend": info.backend, "k2_calls": []}

    def gan_step(variant, disc, disc_opt, name):
        synth = Synthesizer(**cfg_model, weight_norm=True)
        state = init_gan_state(synth, disc, gen_opt, disc_opt, device=dev)
        step = make_train_step(tiny_step_config(variant), group)
        noise = synth.draw_noise(1, T_x, T_y, noise_gen)
        state, metrics = step(state, local, noise, 2e-4, 2e-4, 0.01, 1e-4)
        loss = float(dist.allreduce_metrics({"l": metrics["loss_g_total"]}, group)["l"])
        if not np.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip({n}): {name} loss_g_total {loss}")
        say(f"dryrun_multichip({n}): {name} train step OK loss_g_total={loss:.3f}", flush=True)
        return state, loss

    say(f"dryrun_multichip({n}): {n} rank(s) on {dev.type}, backend {info.backend}", flush=True)
    start = mas.counter.launches
    with mas.recorded(out["k2_calls"]):
        state, out["loss_mel"] = gan_step(
            "mel", MultiPeriodDiscriminator(periods=(2, 3)), Optimizer((0.8, 0.99), 1e-9, 0.0),
            "DP")
        _, out["loss_stft"] = gan_step(
            "stft", tiny_mrd_disc(), Optimizer((0.8, 0.99), 1e-9, 0.0, "radam"),
            "DP stft/MRD")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["k2_launches"] = mas.counter.launches - start

    # the tensor-parallel decoder: (data, model) mesh, the decoder's wide
    # kernels split over `model`, one sharded infer_p2
    if n >= 2:
        synth = state["gen"].eval()
        mesh = make_mesh(data=n // 2, model=2, device=dev)
        tp = make_tp_infer(synth, mesh, "p2", min_channels=32)
        T_x2, T_y2 = 8, 24
        m_p, s_p, _, g = synth.infer_p1(_on(batch["x"][:1, :T_x2], dev),
                                        _on(batch["emo"][:1], dev),
                                        _on(batch["sid"][:1], dev))
        attn = infer_path(torch.full((1, T_x2), float(T_y2 // T_x2), device=dev), T_y2)
        noise = _on(rng.randn(1, T_y2, cfg_model["inter_channels"]).astype(np.float32), dev)
        wav = tp(attn, m_p, s_p, g, noise).cpu()
        if not torch.isfinite(wav).all():
            raise RuntimeError(f"dryrun_multichip({n}): the TP decode is not finite")
        out.update(wav=wav, tp_sharded=len(tp.dec.sharded), tp_numel=tp.decoder_numel(),
                   mesh=repr(mesh))
        say(f"dryrun_multichip({n}): TP decoder infer OK wav={tuple(wav.shape)}", flush=True)
    return out


def _on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _rank_main(rank: int, world: int, store: str, device, out: str):
    """A spawned rank of `dryrun_multichip`: the process group over a
    `file://` store, with the backend of `dist.pick_backend`'s rule, then
    `dryrun_rank`; its numbers saved to `out`."""
    from vits_tpu_torch.parallel import dist
    torch.set_num_threads(1)
    dev, per_card = dist._rank_device(device, rank, world)
    tdist.init_process_group(dist.pick_backend(dev, per_card), init_method=f"file://{store}",
                             rank=rank, world_size=world)
    try:
        res = dryrun_rank(dist.init_distributed(device), world)
    finally:
        dist.shutdown()
    torch.save(res, out)


def dryrun_multichip(n_devices: int, device=None) -> List[Dict]:
    """Start `n_devices` ranks (spawned processes meeting through a
    `file://` store) on `device` (`cuda` unless "cpu"; on cards a rank a
    card, wrapped over the cards, gloo where ranks share one), and run
    `dryrun_rank` on each: one data-parallel mel/MPD step and one stft/MRD
    step at TINY (`utils/tiny.py`), then at n_devices >= 2 one
    tensor-parallel `infer_p2` over a (n // 2, 2) mesh. Asserts finite losses
    and waveform; prints the JAX dry-run's lines. The JAX dry-run's
    `local_batch_to_global` check has no counterpart: each rank feeds its
    own local batch, and no global array is assembled. Returns the ranks'
    numbers (`dryrun_rank`), in rank order, once every rank has exited 0
    within JOIN_S seconds."""
    if n_devices < 1 or (n_devices >= 2 and n_devices % 2):
        raise ValueError(f"dryrun_multichip({n_devices}): 1 rank, or an even number for "
                         "the (n // 2, 2) mesh")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n_devices)]
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, os.path.join(tmp, "store"),
                                                      device, outs[r]))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(JOIN_S)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if alive or codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {codes}"
                               + (f", {len(alive)} killed after {JOIN_S} s" if alive else ""))
        return [torch.load(o, weights_only=False) for o in outs]
