"""One rank of tests/test_torch_tp.py, run in a spawned process of its own
with torch and the port only (no JAX): the process group over gloo from a
`file://` store, one intra-op thread, the job's synthesizer from a JAX
parameter tree, `make_mesh` and `make_tp_infer`, one call; its results are
pickled to `out`."""

import pickle

import torch
import torch.distributed as tdist

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models.synthesizer import Synthesizer
from vits_tpu_torch.parallel.mesh import make_mesh, make_tp_infer


def tp_call(rank, world, store, job, out):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                             world_size=world)
    try:
        synth = params_from_jax(job["params"], Synthesizer(**job["synth"],
                                                           weight_norm=job["weight_norm"]))
        mesh = make_mesh(model=job["model"], device="cpu")
        tp = make_tp_infer(synth.eval(), mesh, job["phase"], min_channels=job["min_channels"])
        got = tp(*(torch.from_numpy(a) for a in job["args"]))
        got = got if isinstance(got, tuple) else (got,)
        res = {"out": [t.numpy() for t in got], "numel": tp.decoder_numel(),
               "synth_dec_numel": sum(p.numel() for n, p in synth.named_parameters()
                                      if n.startswith("dec.")),
               "sharded": tp.dec.sharded, "at": (mesh.data_index, mesh.model_index),
               "backend": mesh.backend}
    finally:
        tdist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
