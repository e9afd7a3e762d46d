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

PORT_MODULES = [
    "vits_tpu_torch", "vits_tpu_torch.config", "vits_tpu_torch.convert",
    "vits_tpu_torch.device", "vits_tpu_torch.infer", "vits_tpu_torch.models.attentions",
    "vits_tpu_torch.models.modules", "vits_tpu_torch.models.synthesizer",
    "vits_tpu_torch.nn.core", "vits_tpu_torch.nn.quant", "vits_tpu_torch.nn.rb_chain",
    "vits_tpu_torch.ops.seq", "vits_tpu_torch.utils.audio", "vits_tpu_torch.utils.checkpoint",
    "vits_tpu_torch.utils.cuda_build", "vits_tpu_torch.utils.summary", "chip_smoke",
]


def _run(code, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120, **kw)


def test_import_loads_no_jax_and_no_vits_tpu():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'vits_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
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
