"""The port's toolkits (`vits_tpu_torch/toolkits/`: del_ckpt, filelists,
mrk2lab, plot_mels, vq_emotion) against their JAX-package twins on the same
seeded inputs: the same return values, the same printed output and the same
files. And the port's ops scripts (`vits_tpu_torch/bin/`): status.sh reports
every service stopped, and the scripts that start Python name only the
port's modules."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from vits_tpu.toolkits import del_ckpt as j_del_ckpt
from vits_tpu.toolkits import filelists as j_filelists
from vits_tpu.toolkits import mrk2lab as j_mrk2lab
from vits_tpu.toolkits import vq_emotion as j_vq
from vits_tpu_torch.toolkits import del_ckpt, filelists, mrk2lab, vq_emotion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "vits_tpu_torch", "bin")

MRK_LINES = [
    "utt1.wav 你好/v 世界/n 。/w|ni3 hao3 shi4 jie4",
    "u2 吗/y|ma6",
    "u3 hello/n ，/w|[ha_lou2]",
    "u4 花/n 儿/n|huar1",
    "u5 it/n 's/u|[it2]",
    "u6 你好/zz|ni3 hao3",
    "u7 你好/v|ni3 hao3 duo1",
    "garbage-without-separator",
    "u8 今天/t 天气/n 很/d 好/a ！/w|jin1 tian1 tian1 qi4 hen3 hao3",
    "",
]


def _run_both(port_main, jax_main, argv, capsys):
    out = []
    for main in (port_main, jax_main):
        main(argv)
        out.append(capsys.readouterr())
    return out


def _write_run_dir(path, steps):
    os.makedirs(path)
    for s in steps:
        for p in "GDP":
            open(os.path.join(path, f"{p}_{s}.npz"), "w").close()
    open(os.path.join(path, "config.json"), "w").close()


@pytest.mark.parametrize("keep", [0, 2, 5])
def test_del_ckpt_keeps_what_the_jax_tool_keeps(tmp_path, keep):
    steps = [1, 10, 200, 3000, 45, 7, 999]
    left = []
    for name, main in (("port", del_ckpt.main), ("jax", j_del_ckpt.main)):
        d = str(tmp_path / name)
        _write_run_dir(d, steps)
        main([d, "--keep", str(keep)])
        left.append(sorted(os.listdir(d)))
    assert left[0] == left[1]
    want = len(steps) if keep == 0 else keep
    assert sum(f.startswith("G_") for f in left[0]) == want


def test_filelists_append_spkid_and_cli(tmp_path, capsys):
    rng = np.random.RandomState(3)
    scp = [f"d/utt{i}.vec|d/utt{i}.wav|d/utt{i}.emo\n" for i in range(12)]
    mapping = {f"utt{i}": str(int(rng.randint(0, 2048))) for i in range(0, 12, 2)}
    assert filelists.append_spkid(scp, mapping) == j_filelists.append_spkid(scp, mapping)
    assert len(filelists.append_spkid(scp, mapping)) == 6
    (tmp_path / "map").write_text("".join(f"{k} {v}\n" for k, v in mapping.items()) + "bad\n")
    (tmp_path / "scp").write_text("".join(scp))
    port, jax_ = _run_both(filelists.main, j_filelists.main,
                           [str(tmp_path / "map"), str(tmp_path / "scp")], capsys)
    assert port.out == jax_.out and port.out.count("\n") == 6


def test_mrk2lab_lines_and_cli(tmp_path, capsys):
    for line in MRK_LINES:
        assert mrk2lab.convert_line(line) == j_mrk2lab.convert_line(line)
        assert mrk2lab.normalize_pinyin_stream(line) == j_mrk2lab.normalize_pinyin_stream(line)
    path = tmp_path / "markup.txt"
    path.write_text("\n".join(MRK_LINES) + "\n", encoding="utf-8")
    port, jax_ = _run_both(mrk2lab.main, j_mrk2lab.main, [str(path)], capsys)
    assert (port.out, port.err) == (jax_.out, jax_.err)
    assert port.out.count("\n") == 6 and port.err.count("\n") == 3


def test_vq_emotion_picks_the_codes_scipy_picks(tmp_path, capsys):
    rng = np.random.RandomState(11)
    centers = rng.randn(16, 1024).astype(np.float32)
    emos = rng.randn(40, 1024).astype(np.float32)
    emos[:16] = centers + 1e-3 * rng.randn(16, 1024).astype(np.float32)
    for e in emos:
        got, want = vq_emotion.quantize(e, centers), j_vq.quantize(e, centers)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (1, 1024)
        np.testing.assert_array_equal(got, want)
    bank = tmp_path / "bank.emo"
    centers.tofile(bank)
    names = []
    for i in range(5):
        names.append(str(tmp_path / f"u{i}.emo"))
        emos[i * 7].tofile(names[-1])
    scp = tmp_path / "emo.scp"
    scp.write_text("# a comment\n\n" + "\n".join(names) + "\n")
    written = {}
    for name, main in (("port", vq_emotion.main), ("jax", j_vq.main)):
        main([str(bank), str(scp)])
        written[name] = (capsys.readouterr().out, [open(n + ".vq", "rb").read() for n in names])
        for n in names:
            os.remove(n + ".vq")
    assert written["port"] == written["jax"]


def test_plot_mels_writes_the_jax_tools_image(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg
    from vits_tpu.toolkits import plot_mels as j_plot_mels
    from vits_tpu_torch.toolkits import plot_mels
    dim, fns = 8, []
    for i in range(2):
        fns.append(str(tmp_path / f"m{i}.bin"))
        np.random.RandomState(i).randn(20, dim).astype(np.float32).tofile(fns[-1])
    images = []
    for name, main in (("port", plot_mels.main), ("jax", j_plot_mels.main)):
        out = str(tmp_path / f"{name}.png")
        main([str(dim), out] + fns)
        assert capsys.readouterr().out == f"saved {out}\n"
        images.append(mpimg.imread(out))
    np.testing.assert_array_equal(images[0], images[1])


def test_port_status_sh_reports_stopped():
    r = subprocess.run(["sh", os.path.join(BIN, "web_api", "status.sh")],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0
    assert r.stdout.splitlines() == [f"{n}: stopped" for n in
                                     ("socket_server", "http_server", "sat_api")]


def test_port_stop_sh_stops_by_pidfile(tmp_path):
    """stop.sh kills the PID of each pidfile in run/ and removes the file;
    status.sh then reports the service stopped. Run on a copy of the
    scripts, so the repo's run/ stays untouched."""
    web = tmp_path / "web_api"
    shutil.copytree(os.path.join(BIN, "web_api"), web)
    (web / "run").mkdir()
    sleeper = subprocess.Popen(["sleep", "60"])
    try:
        (web / "run" / "http_server.pid").write_text(f"{sleeper.pid}\n")
        r = subprocess.run(["sh", str(web / "status.sh")], capture_output=True, text=True,
                           timeout=30)
        assert f"http_server: running (pid {sleeper.pid})" in r.stdout
        r = subprocess.run(["sh", str(web / "stop.sh")], capture_output=True, text=True,
                           timeout=30)
        assert r.stdout.strip() == f"stopped http_server ({sleeper.pid})"
        assert sleeper.wait(timeout=30) != 0
        assert not (web / "run" / "http_server.pid").exists()
    finally:
        sleeper.kill()
        sleeper.wait()


def _python_modules(text: str):
    """The modules a shell script starts or imports from Python: `python3 -m
    M`, `import M` and `from M import` (in -c strings and heredocs)."""
    mods = re.findall(r"python3\s+-m\s+([\w.]+)", text)
    mods += re.findall(r"^\s*from\s+([\w.]+)\s+import", text, re.M)
    mods += re.findall(r"(?:^|[\"';])\s*import\s+([\w.]+)", text, re.M)
    return [m for m in mods if m not in ("sys", "torch")]


@pytest.mark.parametrize("script", ["web_api/start.sh", "sat/adapt.sh", "sat/pre_data.sh",
                                    "sat/path.sh"])
def test_port_scripts_start_only_the_port(script):
    with open(os.path.join(BIN, script)) as f:
        text = f.read()
    mods = _python_modules(text)
    assert mods, f"{script} starts no Python module"
    assert all(m == "vits_tpu_torch" or m.startswith("vits_tpu_torch.") for m in mods), mods
    if script == "web_api/start.sh":
        assert sorted(set(mods)) == [f"vits_tpu_torch.serve.{s}" for s in
                                     ("http_server", "sat_api", "socket_server")]
        assert 'socket_server "$@"' in text
