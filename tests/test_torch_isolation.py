"""The port stands apart from the JAX package and from the CPU: importing
it loads no `jax*` and no `vits_tpu` module, its entry points refuse to run
without a GPU unless the caller asks for the CPU, and `chip_smoke.py` exits
non-zero with no result line when there is no CUDA device."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120, **kw)


def test_import_loads_no_jax_and_no_vits_tpu():
    """Every module of the package (found by walking it, so new ones are
    checked too) and chip_smoke.py import without loading jax or vits_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import vits_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(vits_tpu_torch.__path__,\n"
            "                                              'vits_tpu_torch.')]\n"
            "for m in mods + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'vits_tpu'))\n"
            "serving = {'vits_tpu_torch.' + m for m in ('vits_wrap', 'version',\n"
            "           'utils.torch_compat', 'serve.protocol', 'serve.socket_server',\n"
            "           'serve.http_server')}\n"
            "training = {'vits_tpu_torch.' + m for m in ('config', 'utils.audio',\n"
            "            'utils.checkpoint', 'utils.summary', 'train.data', 'train.loop',\n"
            "            'train.step', 'train.__main__')}\n"
            "deploy = {'vits_tpu_torch.' + m for m in ('export', 'sat', 'serve.aot',\n"
            "          'serve.sat_api', 'toolkits.trim_sil', 'toolkits.cluster_emotion',\n"
            "          'toolkits.extract_emotion')}\n"
            "missing = (serving | training | deploy) - set(mods)\n"
            "print(len(mods), bad, missing)\n"
            "sys.exit(1 if bad or len(mods) < 44 or missing else 0)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from vits_tpu_torch.device import resolve_device
    from vits_tpu_torch.infer import EmoVITS
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmoVITS(str(tmp_path / "checkpoint.npz"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_front_needs_a_gpu_unless_cpu_is_asked(tmp_path):
    """VITSWrap and the socket server refuse to start without a GPU with
    resolve_device's message, before reading a checkpoint or binding a
    port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from vits_tpu_torch.serve.socket_server import TTServer
    from vits_tpu_torch.vits_wrap import VITSWrap
    ckpt = str(tmp_path / "checkpoint.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VITSWrap(ckpt)
    srv = TTServer(port=0, ckpt_path=ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srv.start()
    assert srv.tts is None and srv._sock is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTServer(port=0, ckpt_path=ckpt, device="cuda").start()


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_aot_serving_is_refused(tmp_path, monkeypatch, how):
    """AOT serving outside fp32 is refused, by argument or by VITS_TPU_AOT,
    before anything is read: the programs are exported at fp32, as the JAX
    package's are."""
    from vits_tpu_torch.infer import EmoVITS
    kw = {"aot": True} if how == "argument" else {}
    if how == "environment":
        monkeypatch.setenv("VITS_TPU_AOT", "1")
    with pytest.raises(ValueError, match="fp32"):
        EmoVITS(str(tmp_path / "checkpoint.npz"), device="cpu", compute_dtype="bf16", **kw)


def test_export_programs_need_a_gpu_unless_cpu_is_asked(tmp_path):
    """`python -m vits_tpu_torch.export --convert 1` traces on the card
    unless --device cpu is given, and refuses before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    import json
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.export import main
    from vits_tpu_torch.utils.checkpoint import save_checkpoint
    from vits_tpu_torch.utils.torch_compat import params_template
    hps = get_hparams_from_file(default_config_path("adapt"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hps.to_dict(), f)
    save_checkpoint(str(tmp_path / "G_1.npz"), {"model": params_template(hps)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-o", str(tmp_path / "out"), "--checkpoint", str(tmp_path), "--convert", "1",
              "--verbose", "0"])
    assert not os.path.exists(tmp_path / "out")


def test_training_state_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from vits_tpu_torch.models.synthesizer import Synthesizer
    from vits_tpu_torch.train.loop import init_state
    from vits_tpu_torch.train.optim import Optimizer

    def parts():
        synth = Synthesizer(8, 4, 8, 8, 2, 1, 3, (3,), ((1,),), (2,), 64, (4,),
                            n_speakers=2, gin_channels=4, spec_channels=5, segment_size=2,
                            n_layers_q=1, hidden_size_d=4, n_flows=1, dilation_rate=(1,),
                            weight_norm=True)
        opt = Optimizer((0.8, 0.99), 1e-9, 0.0)
        return synth, MultiPeriodDiscriminator(periods=(2,)), None, opt, opt, None

    hps = HParams(train={"seed": 3})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(hps, *parts())
    state = init_state(hps, *parts(), device="cpu")
    assert next(state["gen"].parameters()).device.type == "cpu"
    assert state["gen"].training and state["step"] == 0


def test_kernel_wrapper_refuses_other_devices():
    from vits_tpu_torch.nn import rb_chain
    x = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rb_chain.resblock2_chain_q8({"kernel_size": 3, "dilation": (1,), "iters": []}, x,
                                    x, x)


def test_chip_smoke_without_cuda_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot import the port and fails whether or not there is a GPU."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_training_run_and_cli_need_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    """`loop.run` and `python -m vits_tpu_torch.train` without --device cpu
    refuse with resolve_device's message before they build a model or read
    data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.train.__main__ import main
    from vits_tpu_torch.train.loop import run
    hps = get_hparams_from_file(default_config_path())
    hps.model_dir = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(hps)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-m", "cli"])
    assert not os.path.exists(hps.model_dir)
    assert sorted(os.listdir(tmp_path / "logs" / "cli")) == ["config.json"]
