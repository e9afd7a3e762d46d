"""TINY configurations and traffic for the benchmark's CPU tests: the
drivers run end to end on the CPU with the program's plain kernels."""

from __future__ import annotations

import copy
import types

TINY_CONFIG = {
    "name": "tiny",
    "assumed": {"frames_per_token": 3.0, "duration_spread": 1.0},
    "train": {"log_interval": 1000, "eval_interval": 1000, "seed": 1234, "epochs": 500,
              "steps": 3000, "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-9,
              "batch_size": 4, "bf16_run": False, "lr_decay": 0.999875, "segment_size": 64,
              "weight_decay": 0.01, "c_mel": 45, "c_dur": 2, "c_kl": 1.0, "c_kl_q": 0.01,
              "align_noise": 1e-2, "align_noise_decay": 1e-6, "align_noise_min": 1e-4,
              "prefetch_workers": 2},
    "data": {"training_files": "unused", "validation_files": "unused", "max_text_len": 384,
             "max_wav_len": 16000, "text_channels": 16, "sampling_rate": 1600,
             "filter_length": 64, "hop_length": 8, "win_length": 64, "n_mel_channels": 20,
             "mel_fmin": 0.0, "mel_fmax": None, "n_speakers": 8, "noise_scale": 0.707},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 2, "kernel_size": 3, "p_dropout": 0.1, "resblock": "2",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 64,
              "upsample_kernel_sizes": [8, 4], "n_layers_q": 2, "hidden_size_d": 16,
              "kernel_size_d": 3, "p_dropout_d": 0.5, "use_spectral_norm": False,
              "gin_channels": 16},
}

TRAFFIC = {
    "serve": {"driver": "serve", "tokens": {"median": 10, "sigma": 0.4, "min": 4, "max": 20},
              "block": 4, "blocks": 2, "trace_seconds": 1,
              "check": {"sample": 3, "limits": {"dur_gap": 0.01, "wav_rel_err": 1e-4}}},
    "batch": {"driver": "batch", "tokens": {"median": 10, "sigma": 0.4, "min": 4, "max": 20},
              "block": 32, "blocks": 1, "batch": 4, "text_quantum": 32, "frame_quantum": 64,
              "trace_seconds": 1,
              "check": {"sample": 2, "limits": {"dur_gap": 0.01, "wav_rel_err": 1e-4}}},
    "train": {"driver": "train",
              "corpus": {"utterances": 8, "seconds": {"median": 0.3, "sigma": 0.3, "min": 0.1,
                                                      "max": 0.9},
                         "buckets": [10, 40, 120], "frames_per_vector": 2},
              "trace_seconds": 1,
              "check": {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-4}}},
}
TRAFFIC["train-ddp"] = {**TRAFFIC["train"], "ranks": 2,
                        "check": {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                                             "update_gap": 1e-3}}}


def cell(traffic: str, config=None, chips: int = 1):
    chips = TRAFFIC[traffic].get("ranks", chips)
    return {"name": "tiny-" + traffic, "chips": chips, "config": "tiny", "traffic": traffic,
            "config_file": copy.deepcopy(config or TINY_CONFIG),
            "traffic_file": copy.deepcopy(TRAFFIC[traffic]), "per_layer": []}


def args(seed: int = 2 ** 31 + 17, seconds: float = 1.0, trace: int = 0):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace, workload="tiny")
