"""The port's export CLI (`python -m vits_tpu_torch.export`) against the JAX
package's (`vits_tpu.export.main`) on the CPU at TINY: a run directory of
three JAX-written G_*.npz (and D_*.npz for the multi-period discriminator
and the MRD) exported by both, the greedy soup, the speaker-embedding reset,
the parameter count, the `.pth` of `save_torch_checkpoint`, and the ONNX
level's refusal to trace without a GPU unless `--device cpu` is given.

Both packages average in float64 and cast to float32, so every exported
leaf is array_equal. The JAX exporter builds its checkpoint template with an
eager `init_params`; the fixtures hand it a zero tree of the same structure
(every leaf is then filled from the files, so the template's values never
reach the output).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import vits_tpu.export as jexport
from test_infer_wrap import TINY_JSON
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.mrd import MultiWaveSTFTDiscriminator as JMRD
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.utils import checkpoint as jck
from vits_tpu.utils.torch_compat import save_torch_checkpoint as j_save_torch_checkpoint

import vits_tpu_torch.export as texport
from vits_tpu_torch.utils import checkpoint as tck
from vits_tpu_torch.utils.torch_compat import save_torch_checkpoint

MODULES = {0: JSynth, 1: JMPD, 2: JMRD}


def _shapes(is_dis, hps):
    module = JSynth.from_hps(hps) if is_dis == 0 else (JMPD(False) if is_dis == 1 else JMRD())
    return jax.eval_shape(module.init_params, jax.random.PRNGKey(0))


def _random_tree(shapes, rng):
    return jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape) * 0.1, s.dtype), shapes)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """TINY config.json, G_1000/2000/3000.npz and D_1000/2000.npz of each
    discriminator (MPD in d1/, MRD in d2/), all written by the JAX package."""
    d = tmp_path_factory.mktemp("run")
    with open(d / "config.json", "w") as f:
        json.dump(TINY_JSON, f)
    hps = jax_get_hparams(str(d / "config.json"))
    rng = np.random.RandomState(0)
    shapes = {i: _shapes(i, hps) for i in MODULES}
    for step in (1000, 2000, 3000):
        jck.save_checkpoint(str(d / f"G_{step}.npz"), {"model": _random_tree(shapes[0], rng)},
                            step=step)
    for i in (1, 2):
        sub = d / f"d{i}"
        sub.mkdir()
        with open(sub / "config.json", "w") as f:
            json.dump(TINY_JSON, f)
        for step in (1000, 2000):
            jck.save_checkpoint(str(sub / f"D_{step}.npz"),
                                {"model": _random_tree(shapes[i], rng)}, step=step)
    return str(d), shapes


@pytest.fixture
def jax_templates(run_dir, monkeypatch):
    """The JAX exporter's templates without an eager init."""
    shapes = run_dir[1]
    for i, cls in MODULES.items():
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes[i])
        monkeypatch.setattr(cls, "init_params", lambda self, key, z=zeros: z)


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _export_both(tmp_path, checkpoint, *flags):
    outs = []
    for name, main in (("jax", jexport.main), ("port", texport.main)):
        out = str(tmp_path / name)
        main(["--outdir", out, "--checkpoint", checkpoint, "--verbose", "0", *flags])
        outs.append(out)
    return outs


def _assert_same_npz(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("flags", [(), ("--init-spk-embed",), ("--greedy", "2")],
                         ids=["soup", "init_spk_embed", "greedy2"])
def test_export_equals_jax(run_dir, jax_templates, tmp_path, flags):
    """checkpoint.npz of the greedy soup (of all three, or of the last two),
    with and without the speaker-embedding reset, leaf by leaf, and the
    config copied beside it."""
    jdir, tdir = _export_both(tmp_path, run_dir[0], *flags)
    _assert_same_npz(os.path.join(jdir, "checkpoint.npz"), os.path.join(tdir, "checkpoint.npz"))
    with open(os.path.join(tdir, "config.json")) as f:
        assert json.load(f) == TINY_JSON
    tree = tck.read_checkpoint(os.path.join(tdir, "checkpoint.npz"))[0]["model"]
    emb = tree["emb_g"]["embedding"]
    if flags == ("--init-spk-embed",):
        np.testing.assert_array_equal(emb, np.broadcast_to(emb[:1], emb.shape))
    else:
        soup = np.mean([np.float64(tck.read_checkpoint(
            os.path.join(run_dir[0], f"G_{s}.npz"))[0]["model"]["emb_g"]["embedding"])
            for s in ((1000, 2000, 3000) if not flags else (2000, 3000))], axis=0)
        np.testing.assert_array_equal(emb, soup.astype(np.float32))


def test_parameter_count_equals_jax(run_dir, jax_templates):
    """The count the reference logs: enc_q and every weight-norm g left out."""
    _, jparams = jexport.load_model(run_dir[0])
    tparams = texport.load_model(run_dir[0])
    n = texport.count_params_like_reference(tparams)
    assert n == jexport.count_params_like_reference(jparams)
    full = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(tparams))
    assert 0 < n < full


def test_pth_equals_jax(run_dir, jax_templates, tmp_path):
    """save_torch_checkpoint of the exported tree: the same keys, shapes,
    dtypes and values as the JAX package's (a state_dict's order is its
    tree's, which is the template's in each package), and the port loads
    it back to the same tree."""
    tparams = texport.load_model(run_dir[0])
    _, jparams = jexport.load_model(run_dir[0])
    save_torch_checkpoint(str(tmp_path / "port.pth"), tparams, iteration=7)
    j_save_torch_checkpoint(str(tmp_path / "jax.pth"), jparams, iteration=7)
    tp = torch.load(str(tmp_path / "port.pth"), weights_only=True)
    jp = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    assert tp["iteration"] == jp["iteration"] == 7
    assert sorted(tp["model"]) == sorted(jp["model"])
    for k, v in jp["model"].items():
        assert tp["model"][k].dtype == v.dtype, k
        torch.testing.assert_close(tp["model"][k], v, rtol=0, atol=0, msg=k)
    back = texport.load_model(str(tmp_path / "port.pth"), texport.config_mod.get_hparams_from_file(
        os.path.join(run_dir[0], "config.json")))
    for (pa, a), (pb, b) in zip(*(sorted(tck._flatten(t).items()) for t in (back, tparams))):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)


@pytest.mark.parametrize("is_dis", [1, 2], ids=["mpd", "mrd"])
def test_discriminator_export_equals_jax(run_dir, jax_templates, tmp_path, is_dis):
    """-d 1 (the multi-period discriminator) and -d 2 (the MRD): the soup of
    the D_*.npz, leaf by leaf (spectral norm's u among the MRD's)."""
    jdir, tdir = _export_both(tmp_path, os.path.join(run_dir[0], f"d{is_dis}"),
                              "-d", str(is_dis))
    _assert_same_npz(os.path.join(jdir, "checkpoint.npz"), os.path.join(tdir, "checkpoint.npz"))


def test_single_file_export(run_dir, jax_templates, tmp_path):
    """A single .npz is exported as itself, as the JAX package does."""
    g = os.path.join(run_dir[0], "G_2000.npz")
    jdir, tdir = _export_both(tmp_path, g)
    _assert_same_npz(os.path.join(jdir, "checkpoint.npz"), os.path.join(tdir, "checkpoint.npz"))
    want = tck.read_checkpoint(g)[0]["model"]["emb_g"]["embedding"]
    got = tck.read_checkpoint(os.path.join(tdir, "checkpoint.npz"))[0]["model"]
    np.testing.assert_array_equal(got["emb_g"]["embedding"], want)


def test_convert_2_needs_a_gpu_unless_cpu_is_asked(run_dir, tmp_path):
    """`--convert 2` (the ONNX level) traces on the card by default: without
    a GPU and without `--device cpu` it raises through resolve_device before
    writing anything. tests/test_torch_onnx.py runs it with `--device
    cpu`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texport.main(["--outdir", str(tmp_path / "o"), "--checkpoint", run_dir[0],
                      "--convert", "2", "--verbose", "0"])
    assert not os.path.exists(tmp_path / "o" / "checkpoint.npz")
