"""Filelist helpers (counterpart of vits_tpu/toolkits/filelists.py): join a
`wavname spkid` map into an scp so each line carries its speaker id, as the
reference's toolkits/appendspkid.pl does.

    python -m vits_tpu_torch.toolkits.filelists <map> <scp> > out.scp
"""

from __future__ import annotations

import argparse
import os


def append_spkid(scp_lines, mapping):
    """scp_lines: 'vec|wav|emo' lines; mapping: {utt_basename: spkid}. Lines
    whose utterance has no speaker id are dropped."""
    out = []
    for line in scp_lines:
        parts = line.strip().split("|")
        base = os.path.splitext(os.path.basename(parts[0]))[0]
        if base in mapping:
            out.append("|".join(parts[:3] + [str(mapping[base])]))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mapfn", help="lines: <utt_basename> <spkid>")
    parser.add_argument("scpfn", help="lines: vec|wav|emo")
    args = parser.parse_args(argv)
    mapping = {}
    with open(args.mapfn) as f:
        for line in f:
            arr = line.split()
            if len(arr) >= 2:
                mapping[arr[0]] = arr[1]
    with open(args.scpfn) as f:
        for line in append_spkid(f, mapping):
            print(line)


if __name__ == "__main__":
    main()
