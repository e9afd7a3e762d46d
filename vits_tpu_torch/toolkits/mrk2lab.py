"""Chinese prosodic markup → label converter (the port's own copy of
vits_tpu/toolkits/mrk2lab.py, which imports nothing of JAX).

    python -m vits_tpu_torch.toolkits.mrk2lab [markup.txt] > labels.txt

Parity with the reference toolkits/mrk2lab.pl (1-153): converts lines of
`<utt_id> <word/POS ...>|<pinyin ...>` into label lines
`<utt_id> <word/pinyin;POS;LANG;;;> ...` for the text frontend's training
data. Behaviors reproduced: pinyin stream normalization (tone-digit spacing,
bracketed English, `*` removal, multi-syllable joining with `_`), erhua (儿)
merging into the previous word when its pinyin ends in `r<tone>`, sentence
punctuation mapping to `sil0`, silent English clitics (`'s`, `n't`, ...),
English `[...]` syllables with tone 2→1 and POS forced to `nx`, Chinese tone
6→2, per-character pinyin joining with `-`, and the GPOS whitelist; malformed
entries are reported to stderr and skipped.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import List, Optional, Tuple

PUNC_SIL = {"。", "！", "？", "！？", "？！", "，", "；", "：", "…", "——"}
GPOS = set("a c d f i m n nr nx nz o p q r t u v w y".split())
SILENT_EN = re.compile(r"^(n't|'ll|'ve|'re|'s|'m|'d|'em|')$", re.IGNORECASE)
HAN = re.compile(r"^[一-鿿㐀-䶿]+$")


def _is_han(s: str) -> bool:
    return bool(HAN.match(s))


def normalize_pinyin_stream(py: str) -> List[str]:
    """Reference pinyin-stream normalization (mrk2lab.pl:44-50)."""
    py = py.lower()
    py = re.sub(r"\s*\*\s*", " ", py)
    py = re.sub(r"(\d+)\s*", r"\1 ", py)
    py = re.sub(r"\s+\]", "]", py)
    py = re.sub(r"(\d)\s+\(", r"\1-(", py)
    py = re.sub(r"([a-z]+)\s+", r"\1_", py)
    return [t for t in py.split() if t]


def convert_line(line: str) -> Tuple[Optional[str], Optional[str]]:
    """Returns (label_line, error). Exactly one of the two is None."""
    line = line.strip()
    if not line:
        return None, None
    m = re.match(r"^(\S+)\s+(.+)\|(.+)$", line)
    if not m:
        return None, f"unparseable line: {line!r}"
    utt_id, seg, py_str = m.group(1), m.group(2), m.group(3)
    utt_id = re.sub(r"\.wav$", "", utt_id, flags=re.IGNORECASE)
    pys = normalize_pinyin_stream(py_str)
    out: List[str] = []
    for token in seg.split():
        m2 = re.match(r"^(.+)/(.+)$", token)
        if not m2:
            return None, f"{utt_id}: bad word/POS token {token!r}"
        wd, cx = m2.group(1), m2.group(2)

        # erhua: merge 儿 into the previous word when its pinyin ends r<tone>
        if wd == "儿" and out:
            m3 = re.match(r"^(.+)/([^;]+)(.+)$", out[-1])
            if m3:
                wd_, py_, left = m3.group(1), m3.group(2), m3.group(3)
                if not re.match(r"^er\d$", py_) and re.search(r"r\d$", py_):
                    out[-1] = f"{wd_}{wd}/{py_}{left}"
                    continue

        lang = "CN"
        if not _is_han(wd) and not re.search(r"[a-zA-Z]+", wd):
            # punctuation
            wd = wd.replace("……", "…")
            wd = re.sub(r"\.{3,}", "…", wd)
            wd = re.sub(r"-{2,}", "——", wd)
            wd = wd.translate(str.maketrans(".!?,;:", "。！？，；："))
            if wd in PUNC_SIL:
                out.append(f"{wd}/sil0;w;{lang};;;")
            else:
                out.append(f"{wd}/;w;{lang};;;")
            continue
        if SILENT_EN.match(wd):
            out.append(f"{wd}/;nx;EN;;;")
            continue
        if not pys:
            return None, f"{utt_id}: ran out of pinyin at {wd}/{cx}"
        py = pys.pop(0)
        if "[" in py or "]" in py:
            # English word
            lang = "EN"
            cx = "nx"
            py = py.replace("[", "").replace("]", "").replace("2", "1")
            if not re.match(r"^[a-zA-Z'.\-]+$", wd):
                return None, f"{utt_id}: english pinyin for non-english word {wd!r}"
        else:
            py = py.replace("6", "2")
            chars = list(wd)
            for ch in chars[1:]:
                if not _is_han(ch):
                    continue
                if not pys:
                    return None, f"{utt_id}: ran out of pinyin inside {wd!r}"
                nxt = pys.pop(0).replace("6", "2")
                py += f"-{nxt}"
        if cx not in GPOS:
            return None, f"{utt_id}: unknown POS {cx!r} for {wd!r}"
        out.append(f"{wd}/{py};{cx};{lang};;;")
    if pys:
        return None, f"{utt_id}: {len(pys)} unconsumed pinyin tokens"
    return " ".join([utt_id] + out), None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert prosodic markup to labels.")
    parser.add_argument("infile", nargs="?", type=argparse.FileType("r", encoding="utf-8"),
                        default=sys.stdin)
    args = parser.parse_args(argv)
    for line in args.infile:
        lab, err = convert_line(line)
        if err:
            print(err, file=sys.stderr)
        elif lab:
            print(lab)


if __name__ == "__main__":
    main()
