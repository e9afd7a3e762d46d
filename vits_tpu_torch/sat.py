"""Speaker-adaptive training (SAT), few-shot voice cloning (counterpart of
vits_tpu/sat.py, the flow of the reference's sat/adapt.sh and
sat/pre_data.sh):

1. per speaker, data prep: silence trim (or a denoiser hook), emotion
   embeddings (`toolkits.extract_emotion`), a K-means emotion bank
   (`toolkits.cluster_emotion`), text -> .vec (a frontend hook; the
   deterministic hash frontend by default);
2. reserved speaker ids counting down from min(1023, n_speakers - 1), one
   per external speaker id (the numeric names of `<sat_dir>/data/*`);
3. train/valid scp files, the train list replicated to at least 50 lines;
4. adapt training (`train.loop.run` with `hps.adapt`: fresh optimizers, the
   step cap, from `pretrain/G_0.npz` and `D_0.npz` where present) on
   `device` (`cuda` unless "cpu") in the config's compute dtype;
5. pruning to the newest 5 checkpoints and the greedy-soup export
   (`vits_tpu_torch.export`) into `out_dir`;
6. `spkid.map` (external id -> reserved id), each bank as `<mapid>.emo`, and
   a `<spkid>.emo` symlink to it, which the serving engine reloads.

`sat_dir` layout: data/<spkid>/*.wav + *.txt, configs/adapt.json,
pretrain/G_0.npz [D_0.npz].
"""

from __future__ import annotations

import functools
import glob
import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np

from vits_tpu_torch.utils.summary import logger

RESERVED_TOP_MAPID = 1023
MIN_TRAIN_LINES = 50


def default_text_frontend(txt_path: str, vec_path: str, text_channels: int):
    """text -> .vec: the deterministic hash frontend (the real text parser
    is external)."""
    from vits_tpu_torch.vits_wrap import HashTextFrontend
    with open(txt_path, "rt", encoding="utf-8") as f:
        text = f.read().strip()
    _, _, vec = HashTextFrontend(text_channels)("u", text)
    vec.astype(np.float32).tofile(vec_path)


def default_emotion_extractor(wav_path: str, emo_path: str, device=None):
    """wav -> 1024-d .emo (`toolkits.extract_emotion.extract_to_file`, its
    model on `device`: `cuda` unless "cpu")."""
    from vits_tpu_torch.toolkits.extract_emotion import extract_to_file
    extract_to_file(wav_path, emo_path, device=device)


def prepare_speaker_data(spk_dir: str, work_dir: str, spkid: str, hps,
                         text_frontend: Optional[Callable] = None,
                         emotion_extractor: Optional[Callable] = None,
                         denoiser: Optional[Callable] = None,
                         n_emotion_clusters: int = 3, device=None) -> List[str]:
    """One speaker's prep into `work_dir/<spkid>`: each wav with a .txt
    beside it trimmed (or denoised), embedded (by default on `device`:
    `cuda` unless "cpu") and its text vectorized; the bank `<spkid>.emo`
    clustered from the embeddings. Returns the scp lines
    `vec|wav|emo|spkid`."""
    from vits_tpu_torch.toolkits.cluster_emotion import cluster_emotions
    from vits_tpu_torch.toolkits.trim_sil import trim_silence_file

    text_frontend = text_frontend or default_text_frontend
    emotion_extractor = emotion_extractor or functools.partial(default_emotion_extractor,
                                                               device=device)
    out_dir = os.path.join(work_dir, spkid)
    os.makedirs(out_dir, exist_ok=True)
    lines, emo_paths = [], []
    for wav in sorted(glob.glob(os.path.join(spk_dir, "*.wav"))):
        base = os.path.splitext(os.path.basename(wav))[0]
        txt = os.path.join(spk_dir, base + ".txt")
        if not os.path.exists(txt):
            logger.warning("no transcript for %s; skipped", wav)
            continue
        wav_out = os.path.join(out_dir, base + ".wav")
        if denoiser is not None:
            denoiser(wav, wav_out)
        else:
            trim_silence_file(wav, wav_out, target_sr=hps.data.sampling_rate)
        emo_out = os.path.join(out_dir, base + ".emo")
        emotion_extractor(wav_out, emo_out)
        emo_paths.append(emo_out)
        vec_out = os.path.join(out_dir, base + ".vec")
        text_frontend(txt, vec_out, hps.data.text_channels)
        lines.append(f"{vec_out}|{wav_out}|{emo_out}|{spkid}")
    if emo_paths:
        bank = cluster_emotions(emo_paths, k=n_emotion_clusters)
        bank.astype(np.float32).tofile(os.path.join(out_dir, f"{spkid}.emo"))
    return lines


def run_adapt(sat_dir: str, out_dir: str, *, config_path: Optional[str] = None,
              pretrain_g: Optional[str] = None, pretrain_d: Optional[str] = None,
              text_frontend=None, emotion_extractor=None, denoiser=None,
              max_steps: Optional[int] = None, device=None) -> Dict[str, int]:
    """The whole adapt flow on `device` (`cuda` unless "cpu"). Returns
    {external spkid: reserved map id}."""
    import vits_tpu_torch.export as export_mod
    from vits_tpu_torch.config import get_hparams_from_file
    from vits_tpu_torch.train.loop import run as train_run
    from vits_tpu_torch.utils import checkpoint as ckpt_mod

    config_path = config_path or os.path.join(sat_dir, "configs", "adapt.json")
    hps = get_hparams_from_file(config_path)
    work_dir = os.path.join(sat_dir, "work")
    os.makedirs(work_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)

    spk_dirs = sorted(d for d in glob.glob(os.path.join(sat_dir, "data", "*"))
                      if os.path.isdir(d) and os.path.basename(d).isdigit())
    if not spk_dirs:
        raise FileNotFoundError(f"no speaker data under {sat_dir}/data")
    # reserved ids count down from 1023, within the config's speaker table
    mapping: Dict[str, int] = {}
    mapid = min(RESERVED_TOP_MAPID, hps.data.n_speakers - 1)
    all_lines: List[str] = []
    for spk_dir in spk_dirs:
        spkid = os.path.basename(spk_dir)
        mapping[spkid] = mapid
        lines = prepare_speaker_data(spk_dir, work_dir, spkid, hps, text_frontend,
                                     emotion_extractor, denoiser, device=device)
        all_lines += ["|".join(line.split("|")[:3] + [str(mapid)]) for line in lines]
        mapid -= 1

    train_lines = list(all_lines)
    while 0 < len(train_lines) < MIN_TRAIN_LINES:
        train_lines += all_lines
    with open(os.path.join(work_dir, "train.scp"), "w") as f:
        f.write("\n".join(train_lines))
    with open(os.path.join(work_dir, "valid.scp"), "w") as f:
        f.write("\n".join(all_lines[:max(1, len(all_lines) // 10)]))

    model_dir = os.path.join(work_dir, "adapt_run")
    os.makedirs(model_dir, exist_ok=True)
    shutil.copyfile(config_path, os.path.join(model_dir, "config.json"))
    hps.model_dir = model_dir
    hps.adapt = True
    hps.use_dur_dis = False
    hps.data.training_files = os.path.join(work_dir, "train.scp")
    hps.data.validation_files = os.path.join(work_dir, "valid.scp")
    hps.ckptG = pretrain_g or os.path.join(sat_dir, "pretrain", "G_0.npz")
    hps.ckptD = pretrain_d or os.path.join(sat_dir, "pretrain", "D_0.npz")
    if not os.path.exists(hps.ckptG):
        hps.ckptG = None
    if not os.path.exists(hps.ckptD):
        hps.ckptD = None
    train_run(hps, variant="mel", max_steps=max_steps, device=device)

    ckpt_mod.prune_checkpoints(model_dir, keep=5, regex="G_*.npz")
    ckpt_mod.prune_checkpoints(model_dir, keep=5, regex="D_*.npz")
    export_mod.main(["--outdir", out_dir, "--checkpoint", model_dir, "--greedy", "5",
                     "--verbose", "0"])

    with open(os.path.join(out_dir, "spkid.map"), "w") as f:
        for spkid, mid in mapping.items():
            f.write(f"{spkid} {mid}\n")
    for spkid, mid in mapping.items():
        src = os.path.join(work_dir, spkid, f"{spkid}.emo")
        if os.path.exists(src):
            # the bank under the reserved id, the external id linked to it
            dst = os.path.join(out_dir, f"{mid}.emo")
            shutil.copyfile(src, dst)
            link = os.path.join(out_dir, f"{spkid}.emo")
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(os.path.basename(dst), link)
    return mapping
