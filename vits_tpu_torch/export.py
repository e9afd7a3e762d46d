"""Training run -> deployable checkpoint (counterpart of vits_tpu/export.py):

    python -m vits_tpu_torch.export -o <outdir> --checkpoint <run dir | .npz | .pth>
        [--config config.json] [-d 0|1|2] [--init-spk-embed] [--greedy-soup N]
        [--convert 0|1|2] [--text-buckets 32,64] [--frame-buckets 128,256]
        [--device cuda|cpu] [--verbose 0|1]

A run directory is read as the greedy soup (the mean) of its last N
`G_*.npz` checkpoints (`D_*.npz` with -d 1, the multi-period discriminator,
or -d 2, MultiWaveSTFTDiscriminator); a file as itself. The speaker
embedding can be reset to row 0 (`--init-spk-embed`). The generator's
parameter count is logged as the reference counts it. The output directory
gets the config and `checkpoint.npz` ({"model": the JAX package's parameter
tree}), which both packages serve. `--convert 1` also writes the bucketed
ahead-of-time programs of `vits_tpu_torch.serve.aot` (traced on --device,
`cuda` by default). `--convert 2`, the ONNX export, is not ported (ROADMAP.md
A7) and raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

import numpy as np

from vits_tpu_torch import config as config_mod
from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.utils import checkpoint as ckpt_mod
from vits_tpu_torch.utils import torch_compat


def _build(hps, is_dis: int):
    from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator
    from vits_tpu_torch.models.synthesizer import Synthesizer
    if is_dis == 0:
        return Synthesizer.from_hps(hps, train=True)
    if is_dis == 1:
        return MultiPeriodDiscriminator(getattr(hps.model, "use_spectral_norm", False))
    return MultiWaveSTFTDiscriminator()


def load_model(checkpoint: str, hps=None, *, greedy: int = 5, is_dis: int = 0):
    """The JAX package's parameter tree (numpy) of the generator (is_dis 0),
    the multi-period discriminator (1) or the MRD (2) from a run dir (the
    greedy soup of its last `greedy` G_*.npz / D_*.npz), a `.npz` or a
    reference `.pth`/`.pt`. Leaves the files lack keep the template's zeros
    (logged)."""
    if hps is None:
        dirname = checkpoint if os.path.isdir(checkpoint) else os.path.dirname(checkpoint)
        hps = config_mod.get_hparams_from_file(os.path.join(dirname, "config.json"))
    template = {"model": torch_compat.tree_template(lambda: _build(hps, is_dis))}
    if os.path.isdir(checkpoint):
        paths = ckpt_mod.checkpoint_paths_sorted(checkpoint,
                                                 "G_*.npz" if is_dis == 0 else "D_*.npz")
        if not paths:
            raise FileNotFoundError(f"no checkpoints in {checkpoint}")
        logging.info("Load [%s]", paths[-1])
        if greedy > 0 and len(paths) > 1:
            state = ckpt_mod.greedy_soup(paths, template, greedy=greedy)
        else:
            state, _, _ = ckpt_mod.load_checkpoint(paths[-1], template)
    elif checkpoint.endswith((".pth", ".pt")):
        return torch_compat.load_torch_checkpoint(checkpoint, template["model"])
    else:
        state, _, _ = ckpt_mod.load_checkpoint(checkpoint, template)
    return state["model"]


def count_params_like_reference(params) -> int:
    """Elements of a parameter tree leaving out enc_q and the weight-norm g
    leaves, as the reference counts the exported generator."""
    total = 0

    def rec(t, path):
        nonlocal total
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, path + [k])
        elif not ("enc_q" in path or path[-1] == "g"):
            total += int(np.prod(np.shape(t)))

    rec(params, [])
    return total


def _buckets(arg: str):
    return tuple(int(s) for s in arg.split(","))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export the port's TTS model.")
    parser.add_argument("--outdir", "-o", type=str, required=True)
    parser.add_argument("--checkpoint", "--ckpt", type=str, required=True)
    parser.add_argument("--config", "--conf", default=None, type=str)
    parser.add_argument("--discriminator", "--dis", "-d", default=0, type=int)
    parser.add_argument("--init-spk-embed", action="store_true")
    parser.add_argument("--greedy-soup", "--greedy", default=5, type=int)
    parser.add_argument("--convert", "-c", default=0, type=int,
                        help="1: also write the bucketed infer_p1/p2 programs (.pt2); "
                             "2: ONNX, not ported (ROADMAP.md A7)")
    parser.add_argument("--text-buckets", type=str, default=None,
                        help="comma-separated text buckets for --convert")
    parser.add_argument("--frame-buckets", type=str, default=None,
                        help="comma-separated frame buckets for --convert")
    parser.add_argument("--device", default=None,
                        help="torch device the programs are traced on (default cuda)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    if args.convert >= 2:
        raise NotImplementedError("--convert 2 (ONNX export) is not ported: ROADMAP.md A7")
    dev = resolve_device(args.device) if args.convert and not args.discriminator else None

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARN, stream=sys.stdout)
    os.makedirs(args.outdir, exist_ok=True)
    if args.config is None:
        dirname = args.checkpoint if os.path.isdir(args.checkpoint) \
            else os.path.dirname(args.checkpoint)
        config_path = os.path.join(dirname, "config.json")
    else:
        config_path = args.config
    hps = config_mod.get_hparams_from_file(config_path)

    params = load_model(args.checkpoint, hps, greedy=args.greedy_soup, is_dis=args.discriminator)
    if args.init_spk_embed and not args.discriminator:
        logging.info("Reset speaker embedding!")
        emb = np.asarray(params["emb_g"]["embedding"])
        params["emb_g"]["embedding"] = np.broadcast_to(emb[:1], emb.shape).copy()
    if not args.discriminator:
        logging.info("Total parameters: %d", count_params_like_reference(params))

    out_config = os.path.join(args.outdir, "config.json")
    if not (os.path.exists(out_config) and os.path.samefile(config_path, out_config)):
        shutil.copyfile(config_path, out_config)
    ckpt_mod.save_checkpoint(os.path.join(args.outdir, "checkpoint.npz"), {"model": params})
    logging.info("Exported parameters from [%s] to [%s/checkpoint.npz]",
                 args.checkpoint, args.outdir)

    if args.convert and not args.discriminator:
        from vits_tpu_torch.convert import params_from_jax
        from vits_tpu_torch.models.synthesizer import Synthesizer
        from vits_tpu_torch.serve.aot import export_aot
        synth = params_from_jax(params, Synthesizer.from_hps(hps)).to(dev).eval()
        kw = {}
        if args.text_buckets:
            kw["text_buckets"] = _buckets(args.text_buckets)
        if args.frame_buckets:
            kw["frame_buckets"] = _buckets(args.frame_buckets)
        n = export_aot(synth, args.outdir, hps, **kw)
        logging.info("AOT-exported %d bucketed programs to %s", n, args.outdir)


if __name__ == "__main__":
    main()
