"""Training CLI, the stft/MRD variant (the twin of the repository's
train_stft.py: the multi-resolution STFT loss and MultiWaveSTFTDiscriminator,
RAdam for the discriminators):

    python -m vits_tpu_torch.train_stft -m <name> [-c config.json] [-a] [-d]
        [--ckptG G.npz] [--ckptD D.npz] [--device cuda|cpu]

The run dir is ./logs/<name>; training resumes from its latest
checkpoints. The device is `cuda` unless --device cpu is given.
"""

from vits_tpu_torch.config import get_hparams
from vits_tpu_torch.train.loop import run


def main(args=None):
    hps = get_hparams(args)
    return run(hps, variant="stft", device=hps.device)


if __name__ == "__main__":
    main()
