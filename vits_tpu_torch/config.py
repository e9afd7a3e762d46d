"""Config loading: recursive attribute-dict HParams over a JSON config, and
the training CLI's flags with the run-dir config snapshot (own copy of
vits_tpu/config.py)."""

from __future__ import annotations

import argparse
import json
import os


class HParams:
    """Recursive attribute dict over a JSON config."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, HParams) else v) for k, v in self.items()}

    def __len__(self):
        return len(self.__dict__)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        return setattr(self, key, value)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return self.__dict__.__repr__()


def get_hparams_from_file(config_path: str) -> HParams:
    with open(config_path, "r") as f:
        config = json.load(f)
    return HParams(**config)


def get_hparams_from_dir(model_dir: str) -> HParams:
    """The config snapshotted into a run dir, with `model_dir` set."""
    hps = get_hparams_from_file(os.path.join(model_dir, "config.json"))
    hps.model_dir = model_dir
    return hps


def default_config_path(name: str = "base") -> str:
    """The repo's `configs/<name>.json`."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        f"{name}.json")


def get_hparams(args=None, init: bool = True) -> HParams:
    """The training CLI's config (vits_tpu/config.py `get_hparams`): -c the
    config JSON (default configs/base.json), -m the run name (run dir
    ./logs/<model>), -a adapt (reset the step count and the optimizers), -d
    the duration discriminator, --ckptG/--ckptD explicit checkpoints to
    resume, --device the training device (default cuda). With `init` the
    config is copied into the run dir; without it the run dir's copy is
    read."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="JSON configuration file")
    parser.add_argument("-m", "--model", type=str, required=True, help="model/run name")
    parser.add_argument("-a", "--adapt", action="store_true",
                        help="speaker-adaptive finetune: reset step count + fresh optimizer")
    parser.add_argument("-d", "--use-dur-dis", action="store_true",
                        help="train with the adversarial duration discriminator")
    parser.add_argument("--ckptG", type=str, required=False, help="generator checkpoint to resume")
    parser.add_argument("--ckptD", type=str, required=False,
                        help="discriminator checkpoint to resume")
    parser.add_argument("--device", type=str, default="cuda",
                        help="training device: cuda (default) or cpu")
    args = parser.parse_args(args)

    model_dir = os.path.join("./logs", args.model)
    os.makedirs(model_dir, exist_ok=True)
    config_save_path = os.path.join(model_dir, "config.json")
    if init:
        with open(args.config or default_config_path(), "r") as f:
            data = f.read()
        with open(config_save_path, "w") as f:
            f.write(data)
    else:
        with open(config_save_path, "r") as f:
            data = f.read()

    hps = HParams(**json.loads(data))
    hps.model_dir = model_dir
    hps.adapt = args.adapt
    hps.use_dur_dis = args.use_dur_dis
    hps.ckptG = args.ckptG
    hps.ckptD = args.ckptD
    hps.device = args.device
    return hps
