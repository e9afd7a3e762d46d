"""The port's ONNX export (`vits_tpu_torch.onnx`) against the JAX package's
(`vits_tpu.onnx`) at TINY on the CPU, the port's runtime on device="cpu".

From the JAX package's `init_params` weights carried by `params_from_jax`:
- the port's model_p1.onnx and model_p2.onnx, evaluated by the port's runtime
  and by `vits_tpu.onnx.runtime`, match JAX `infer_p1` / `infer_p2` (p2 on
  the unpacked decoder, as the JAX export traces it) at atol 2e-4, rtol
  2e-3, the tolerance tests/test_onnx.py holds the JAX files to, and the
  JAX package's own files on the same inputs at the same tolerance; p1 at
  the traced length and at two others;
- the I/O contract (names, element types, shapes with their dim_params),
  the opset and the IR version equal the JAX files';
- every op_type lies in the JAX evaluator's op set;
- the port's runtime on the JAX package's files equals the JAX runtime
  within 1e-6 absolute plus 1e-6 relative (a few float32 ulps: the port
  accumulates MatMul in float64, the JAX evaluator in float32, and their
  exp and sigmoid round apart);
- each package's writer's bytes parse with the other's reader;
- the CLI's check and `--run`, `python -m vits_tpu_torch.export --convert 2
  --device cpu` (both files, matching JAX, plus the .pt2 programs), an
  unmapped ATen op raising by name, and a ResBlock1 + Swish model.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_model_parity import TINY
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.nn.core import fold_weight_norm
from vits_tpu.onnx import export_p1 as j_export_p1
from vits_tpu.onnx import export_p2 as j_export_p2
from vits_tpu.onnx import proto as jproto
from vits_tpu.onnx import runtime as jruntime

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.onnx import convert, export_p1, export_p2, proto, runtime
from vits_tpu_torch.onnx.__main__ import main as cli
from vits_tpu_torch.utils import checkpoint as tck

ATOL, RTOL = 2e-4, 2e-3
T_X, T_Y = 12, 40
P1_LENGTHS = (T_X, 7, 20)
# the JAX evaluator's op set (vits_tpu/onnx/runtime.py:94-199)
JAX_OPS = set(jruntime._BINOPS) | set(jruntime._UNOPS) | {
    "Where", "Cast", "Reshape", "Squeeze", "Unsqueeze", "Transpose", "Expand", "Slice",
    "Concat", "Pad", "Einsum", "MatMul", "Conv", "Gather", "Shape", "ReduceSum", "ReduceMax",
    "ReduceMin", "CumSum", "Mod", "Range"}
PORT_ARGS = [k for k in TINY if k not in ("spec_channels", "segment_size", "p_dropout",
                                          "kernel_size_q", "n_layers_q", "p_dropout_d")]


def _port_cfg(cfg):
    return {k: cfg[k] for k in PORT_ARGS}


def _models(cfg):
    js = JSynth(**cfg)
    params = js.init_params(jax.random.PRNGKey(0))
    ts = params_from_jax(params, TSynth(**_port_cfg(cfg))).eval()
    return js, params, fold_weight_norm(params), ts


@pytest.fixture(scope="module")
def files():
    """Both packages' p1 and p2 files of the same TINY weights."""
    js, params, pf, ts = _models(TINY)
    return {"js": js, "pf": pf,
            "port": {"p1": export_p1(ts, T_X), "p2": export_p2(ts, T_X, T_Y)},
            "jax": {"p1": j_export_p1(js, params, t_x=T_X),
                    "p2": j_export_p2(js, params, t_x=T_X, t_y=T_Y)}}


def p1_inputs(cfg, t_x, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_text": rng.randn(1, t_x, cfg["text_channels"]).astype(np.float32),
            "input_emo": rng.randn(1, 1024).astype(np.float32),
            "input_g": np.array([2], np.int64)}


def p1_reference(js, pf, inp):
    m_p, s_p, logw, g = js.infer_p1(
        pf, jnp.asarray(inp["input_text"]), jnp.asarray(inp["input_emo"]),
        jnp.asarray(inp["input_g"], jnp.int32))
    return {"output_m_p": np.swapaxes(np.asarray(m_p), 1, 2),
            "output_s_p": np.swapaxes(np.asarray(s_p), 1, 2),
            "output_logw": np.swapaxes(np.asarray(logw), 1, 2), "output_g": np.asarray(g)}


def p2_inputs(cfg, t_x=T_X, t_y=T_Y, seed=1):
    rng = np.random.RandomState(seed)
    attn = np.zeros((1, t_y, t_x), np.float32)
    durations = np.full(t_x, t_y // t_x)
    durations[: t_y % t_x] += 1
    for i, start in enumerate(np.concatenate([[0], np.cumsum(durations)[:-1]])):
        attn[0, start:start + durations[i], i] = 1.0
    C = cfg["inter_channels"]
    return {"input_attn": attn, "input_m_p": rng.randn(1, C, t_x).astype(np.float32),
            "input_s_p": np.abs(rng.randn(1, C, t_x)).astype(np.float32),
            "input_g": rng.randn(1, cfg["gin_channels"]).astype(np.float32),
            "input_noise": (0.3 * rng.randn(1, C, t_y)).astype(np.float32)}


def p2_reference(js, pf, inp):
    sw = lambda k: jnp.asarray(np.swapaxes(inp[k], 1, 2))  # noqa: E731
    wav = js.infer_p2(pf, jnp.asarray(inp["input_attn"]), sw("input_m_p"), sw("input_s_p"),
                      jnp.asarray(inp["input_g"]), sw("input_noise"), packed=False)
    return {"output_wav": np.swapaxes(np.asarray(wav), 1, 2)}


def evaluate(which, model_bytes, inp):
    if which == "port":
        return {k: v.numpy() for k, v in runtime.run_model(model_bytes, inp, "cpu").items()}
    return jruntime.run_model(model_bytes, inp)


def _close(out, ref, what):
    assert set(out) == set(ref), what
    for k, v in ref.items():
        assert out[k].shape == v.shape, (what, k)
        np.testing.assert_allclose(out[k], v, atol=ATOL, rtol=RTOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("t_x", P1_LENGTHS, ids=["traced", "shorter", "longer"])
@pytest.mark.parametrize("which", ["port", "jax"], ids=["port_runtime", "jax_runtime"])
def test_p1_matches_jax_at_any_length(files, which, t_x):
    inp = p1_inputs(TINY, t_x, seed=t_x)
    out = evaluate(which, files["port"]["p1"], inp)
    _close(out, p1_reference(files["js"], files["pf"], inp), f"p1 T={t_x}")
    _close(out, jruntime.run_model(files["jax"]["p1"], inp), f"p1 T={t_x} vs the JAX file")


@pytest.mark.parametrize("which", ["port", "jax"], ids=["port_runtime", "jax_runtime"])
def test_p2_matches_jax(files, which):
    inp = p2_inputs(TINY)
    out = evaluate(which, files["port"]["p2"], inp)
    _close(out, p2_reference(files["js"], files["pf"], inp), "p2")
    _close(out, jruntime.run_model(files["jax"]["p2"], inp), "p2 vs the JAX file")


@pytest.mark.parametrize("phase", ["p1", "p2"])
def test_io_contract_equals_the_jax_files(files, phase):
    ours, theirs = (proto.parse_model(files[k][phase]) for k in ("port", "jax"))
    for key in ("ir_version", "opset"):
        assert ours[key] == theirs[key], key
    assert ours["opset"] == 17 and ours["producer"] == "vits_tpu_torch"
    for io in ("input", "output"):
        assert ours["graph"][io] == theirs["graph"][io], io
    assert ours["graph"]["name"] == theirs["graph"]["name"]
    assert json.loads(ours["doc"].split("traced_shapes=")[1]) == \
        json.loads(theirs["doc"].split("traced_shapes=")[1])


@pytest.mark.parametrize("phase", ["p1", "p2"])
def test_every_op_is_in_the_jax_runtimes_set(files, phase):
    ops = {n["op_type"] for n in proto.parse_model(files["port"][phase])["graph"]["node"]}
    assert ops <= JAX_OPS, sorted(ops - JAX_OPS)
    assert "Conv" in ops and "MatMul" in ops


@pytest.mark.parametrize("phase", ["p1", "p2"])
def test_the_port_runtime_equals_the_jax_runtime_on_the_jax_files(files, phase):
    inp = p1_inputs(TINY, 9, seed=4) if phase == "p1" else p2_inputs(TINY, seed=5)
    ours = evaluate("port", files["jax"][phase], inp)
    theirs = jruntime.run_model(files["jax"][phase], inp)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_writers_bytes_parse_with_the_other_reader(files, writer):
    data = files[writer]["p1"]
    mine, other = (proto, jproto) if writer == "port" else (jproto, proto)
    assert other.parse_model(data) == mine.parse_model(data)
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = other.parse_tensor(mine.tensor_proto("t", arr))
    np.testing.assert_array_equal(other.tensor_to_np(t), arr)
    assert proto.tensor_proto("s", np.float32(3.5)) == jproto.tensor_proto("s", np.float32(3.5))


def test_cli_check_and_run(files, tmp_path, capsys):
    path = tmp_path / "m.onnx"
    path.write_bytes(files["port"]["p1"])
    assert cli([str(path), "--run", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "structure: OK" in out and "run: OK" in out and "on cpu" in out
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(files["port"]["p1"][: len(files["port"]["p1"]) // 2])
    try:
        rc = cli([str(bad), "--run", "--device", "cpu"])
    except Exception:
        rc = 1
    assert rc != 0
    capsys.readouterr()
    assert cli([str(path)]) == 0  # the structural check needs no device
    out = capsys.readouterr().out
    assert "structure: OK" in out and "run: OK" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli([str(path), "--run"])


def test_export_cli_convert_2_writes_both_files_and_the_programs(tmp_path):
    """`python -m vits_tpu_torch.export --convert 2 --device cpu` on a
    checkpoint.npz of JAX weights: the .pt2 programs of --convert 1 and both
    ONNX files, which the JAX runtime evaluates to JAX's infer_p1 /
    infer_p2."""
    from test_torch_synth import TINY_JSON
    from vits_tpu.config import get_hparams_from_file as jax_get_hparams

    src = tmp_path / "src"
    src.mkdir()
    (src / "config.json").write_text(json.dumps(TINY_JSON))
    js = JSynth.from_hps(jax_get_hparams(str(src / "config.json")))
    params = jax.tree_util.tree_map(np.asarray, js.init_params(jax.random.PRNGKey(3)))
    tck.save_checkpoint(str(src / "G_1.npz"), {"model": params})
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, "-m", "vits_tpu_torch.export", "-o", str(out),
                        "--checkpoint", str(src / "G_1.npz"), "--convert", "2",
                        "--text-buckets", "16", "--frame-buckets", "32", "--onnx-tx", "10",
                        "--onnx-ty", "30", "--device", "cpu", "--verbose", "0"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(_root())}, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    files = sorted(p.name for p in out.iterdir())
    assert {"model_p1.onnx", "model_p2.onnx", "model_p1_t16.pt2",
            "model_p2_t16_f32.pt2", "checkpoint.npz"} <= set(files), files
    cfg = {**TINY_JSON["model"], "text_channels": TINY_JSON["data"]["text_channels"]}
    pf = fold_weight_norm(params)
    for t_x in (10, 15):
        inp = p1_inputs(cfg, t_x, seed=t_x)
        _close(jruntime.run_model((out / "model_p1.onnx").read_bytes(), inp),
               p1_reference(js, pf, inp), f"CLI p1 T={t_x}")
    inp = p2_inputs(cfg, 10, 30)
    _close(jruntime.run_model((out / "model_p2.onnx").read_bytes(), inp),
           p2_reference(js, pf, inp), "CLI p2")


def _root():
    return pathlib.Path(__file__).resolve().parent.parent


def test_an_unmapped_aten_op_raises_naming_it():
    class Odd(torch.nn.Module):
        def forward(self, x):
            return torch.atan(x) + 1.0

    ep = torch.export.export(Odd(), (torch.zeros(2, 3),), strict=False).run_decompositions()
    with pytest.raises(NotImplementedError, match="aten.atan.default"):
        convert.convert_program(ep, ["x"], ["y"], (torch.zeros(2, 3),))


def test_a_resblock1_swish_model_exports_and_matches_jax():
    cfg = {**TINY, "resblock": "1", "act_func_d": "swish"}
    js, params, pf, ts = _models(cfg)
    params["dp"]["act_1"]["weight"] = np.float32([0.6])
    pf = fold_weight_norm(params)
    ts = params_from_jax(params, TSynth(**_port_cfg(cfg))).eval()
    p1, p2 = export_p1(ts, T_X), export_p2(ts, T_X, T_Y)
    for t_x in (T_X, 17):
        inp = p1_inputs(cfg, t_x, seed=t_x)
        ref = p1_reference(js, pf, inp)
        for which in ("port", "jax"):
            _close(evaluate(which, p1, inp), ref, f"{which} ResBlock1 p1 T={t_x}")
    inp = p2_inputs(cfg)
    ref = p2_reference(js, pf, inp)
    for which in ("port", "jax"):
        _close(evaluate(which, p2, inp), ref, f"{which} ResBlock1 p2")


@pytest.mark.skipif(shutil.which("protoc") is None, reason="protoc not in image")
def test_protoc_decodes_the_port_files(files):
    proto_dir = _root() / "tools"
    r = subprocess.run(["protoc", f"-I{proto_dir}", "--decode=vits_tpu_onnx.ModelProto",
                        "onnx_subset.proto"], input=files["port"]["p1"], capture_output=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr.decode()[:2000]
    text = r.stdout.decode()
    assert 'op_type: "Conv"' in text and 'dim_param: "text_len"' in text
