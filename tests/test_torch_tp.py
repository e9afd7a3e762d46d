"""Tensor parallelism of the port's decoder (`vits_tpu_torch.parallel.mesh`)
against the JAX package's (`vits_tpu.parallel.mesh`) on the CPU.

The sharded set: the port's rule selects, tensor for tensor through
`convert`'s naming, the leaves JAX's `generator_param_specs` selects: at
the graft entry's TINY config (min_channels 32) and at configs/base.json
(min_channels 128), at model 2 and 4, on the training tree and on the
serving one, built without weights on both sides (`jax.eval_shape`, the
meta device). At the base config: 57 decoder leaves, 14,458,880 parameters;
a rank holds 8,667,072 of the training tree's decoder parameters at model
2 and 5,052,352 at model 4.

The slices: each rank's slices, concatenated, are bit-equal to the whole
(folded) tensor, for `shard_generator_params` and for the sharded layers
`make_tp_infer` builds; the synthesizer's decoder is then the sharded one,
and a rank holds no whole split kernel.

The output: 2 and 4 gloo ranks (spawned, tests/torch_tp_rank.py, one
intra-op thread, each joined within JOIN_S seconds) give the same
`infer_p2` on every rank, within atol 2e-5 of JAX's replicated `infer_p2`
and of JAX's sharded jit on the conftest's 8-device CPU mesh (the decoder
split over `model` at min_channels 32, as tests/test_tensor_parallel.py
jits it): resblock "2" and "1", serving trees and weight-normed training
trees, (data, model) meshes of (1, 2), (1, 4) and (2, 2); and `phase="p1"`
against JAX's `make_tp_infer(..., "p1")`.

Float only: the int8 entry points of a sharded decoder raise.
"""

import copy
import multiprocessing
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__
import torch_tp_rank
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu.config import default_config_path as j_default_config_path
from vits_tpu.config import get_hparams_from_file as j_get_hparams
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.ops.seq import infer_path as j_infer_path
from vits_tpu.parallel import mesh as jmesh

from vits_tpu_torch.config import default_config_path, get_hparams_from_file
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import fold_module_weight_norm, init_weights
from vits_tpu_torch.parallel.mesh import (Mesh, ShardedLayer, TPDecoder, generator_param_specs,
                                          make_mesh, make_tp_infer, shard_generator_params)

JOIN_S = 120
ATOL = 2e-5
LEAF = {"w": "weight", "v": "weight_v", "g": "weight_g", "b": "bias", "embedding": "weight"}
T_X, T_Y = 12, 40


def _cfg(resblock="2", serving=False):
    cfg = dict(__graft_entry__._tiny_cfg(), resblock=resblock)
    if serving:
        del cfg["spec_channels"], cfg["segment_size"]
    return cfg


def _jax_sharded_keys(shape_tree, model, min_channels, leaf_v="weight_v"):
    """The port's state-dict keys of the leaves JAX's rule shards."""
    mesh = jmesh.make_mesh(data=8 // model, model=model)
    specs = jmesh.generator_param_specs(shape_tree, mesh, min_channels=min_channels)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    keys = set()
    for path, spec in flat:
        if spec.spec == P():
            continue
        names = [k.key for k in path]
        leaf = leaf_v if names[-1] == "v" else LEAF[names[-1]]
        keys.add(".".join(names[:-1] + [leaf]))
    return keys


def _port_sharded(state, model, min_channels):
    return {k for k, d in generator_param_specs(state, model, min_channels).items()
            if d is not None}


def _trees(config, resblock):
    """(JAX training-tree shapes, the port's training and serving state dicts
    on the meta device)."""
    if config == "tiny":
        js = JSynth(**_cfg(resblock))
        with torch.device("meta"):
            train = TSynth(**_cfg(resblock), weight_norm=True).state_dict()
            serve = TSynth(**_cfg(resblock, serving=True)).state_dict()
    else:
        jh = j_get_hparams(j_default_config_path("base"))
        th = get_hparams_from_file(default_config_path("base"))
        jh.model.resblock = th.model.resblock = resblock
        js = JSynth.from_hps(jh)
        with torch.device("meta"):
            train = TSynth.from_hps(th, train=True).state_dict()
            serve = TSynth.from_hps(th).state_dict()
    return jax.eval_shape(js.init_params, jax.random.PRNGKey(0)), train, serve


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("config,min_channels", [("tiny", 32), ("base", 128)])
def test_sharded_set_is_the_jax_rules(config, min_channels, model):
    tree, train, serve = _trees(config, "2")
    want = _jax_sharded_keys(tree, model, min_channels)
    got = _port_sharded(train, model, min_channels)
    assert got == want and got
    assert _port_sharded(serve, model, min_channels) == \
        _jax_sharded_keys(tree, model, min_channels, leaf_v="weight")
    assert all(k.startswith("dec.") for k in got)
    if config == "base":
        assert len(got) == 57
        assert sum(train[k].numel() for k in got) == 14_458_880
        dec = sum(t.numel() for k, t in train.items() if k.startswith("dec."))
        assert dec == 15_896_512
        for r in range(model):
            mine = shard_generator_params(Mesh(1, model, r, torch.device("cpu"), None), train)
            held = sum(t.numel() for k, t in mine.items() if k.startswith("dec."))
            assert held == {2: 8_667_072, 4: 5_052_352}[model]


@pytest.mark.parametrize("config", ["tiny", "base"])
def test_sharded_set_with_resblock_1(config):
    tree, train, serve = _trees(config, "1")
    mc = 32 if config == "tiny" else 128
    for model in (2, 4):
        assert _port_sharded(train, model, mc) == _jax_sharded_keys(tree, model, mc)
        assert _port_sharded(serve, model, mc) == _jax_sharded_keys(tree, model, mc, "weight")


def test_specs_leave_indivisible_and_narrow_tensors_replicated():
    with torch.device("meta"):
        state = TSynth(**_cfg(serving=True)).state_dict()
    specs = generator_param_specs(state, 2, 32)
    assert specs["dec.conv_pre.weight"] == 0          # (64, 8, 7): C_out 64
    assert specs["dec.ups.0.weight"] == 1             # (64, 32, 8): C_out 32 on dim 1
    assert specs["dec.ups.1.weight"] is None          # C_out 16 < 32
    assert specs["dec.conv_post.weight"] is None      # C_out 1
    assert specs["dec.conv_pre.bias"] is None and specs["flow.flows.0.pre.weight"] is None
    assert all(d is None for d in generator_param_specs(state, 3, 32).values())  # 3 divides none
    assert all(d is None for d in generator_param_specs(state, 1, 1).values())


@pytest.mark.parametrize("resblock", ["2", "1"])
def test_slices_concatenate_to_the_whole(one_torch_thread, resblock):  # noqa: F811
    synth = init_weights(TSynth(**_cfg(resblock), weight_norm=True),
                         torch.Generator().manual_seed(4)).eval()
    full = synth.state_dict()
    folded = {f"dec.{k}": v for k, v in
              fold_module_weight_norm(copy.deepcopy(synth.dec)).state_dict().items()}
    for model in (2, 4):
        meshes = [Mesh(1, model, r, torch.device("cpu"), None) for r in range(model)]
        specs = generator_param_specs(full, model, 32)
        parts = [shard_generator_params(m, full, 32) for m in meshes]
        for k, d in specs.items():
            if d is None:
                assert all(p[k] is full[k] for p in parts)
            else:
                assert all(p[k].shape[d] == full[k].shape[d] // model for p in parts)
                assert torch.equal(torch.cat([p[k] for p in parts], dim=d), full[k])
        decs = [TPDecoder(synth.dec, m, 32) for m in meshes]
        layers = [{n: mod for n, mod in dec.gen.named_modules() if isinstance(mod, ShardedLayer)}
                  for dec in decs]
        sharded = {f"dec.{n}.weight" for n in layers[0]}
        assert sharded == {k.replace("weight_v", "weight") for k, d in specs.items()
                           if d is not None}
        for name in layers[0]:
            key = f"dec.{name}.weight"
            d = 1 if ".ups." in key else 0
            cat = torch.cat([ls[name].layer.weight for ls in layers], dim=d)
            assert torch.equal(cat, folded[key]), key
            cat = torch.cat([ls[name].layer.bias for ls in layers])
            assert torch.equal(cat, folded[f"dec.{name}.bias"]), key


def test_a_tp_decoder_is_float_only(one_torch_thread):  # noqa: F811
    synth = init_weights(TSynth(**_cfg(serving=True)), torch.Generator().manual_seed(0)).eval()
    tp = make_tp_infer(synth, Mesh(1, 2, 0, torch.device("cpu"), "gloo"), min_channels=32)
    assert tp.dec.sharded and synth.dec is tp.dec  # the whole decoder is let go
    z, g = torch.zeros(1, 8, 8), torch.zeros(1, 16)
    for call in (lambda: tp.dec.quantize({}), lambda: tp.dec.calibrate(z, g),
                 lambda: tp.dec.forward_q8({}, z, g),
                 lambda: tp(torch.zeros(1, 8, 4), torch.zeros(1, 4, 8), torch.ones(1, 4, 8), g,
                            z, dec_q8={})):
        with pytest.raises(NotImplementedError, match="float only"):
            call()
    with pytest.raises(ValueError):
        make_tp_infer(synth, Mesh(1, 2, 0, torch.device("cpu"), "gloo"), phase="p3")


def test_make_tp_infer_takes_the_decoder_over(one_torch_thread):  # noqa: F811
    """The synthesizer's decoder becomes the sharded one, which p1 and p2
    over the same mesh share; another mesh is refused."""
    synth = init_weights(TSynth(**_cfg(serving=True)), torch.Generator().manual_seed(0)).eval()
    whole = synth.dec
    mesh = Mesh(1, 2, 0, torch.device("cpu"), "gloo")
    p1 = make_tp_infer(synth, mesh, "p1", min_channels=32)
    p2 = make_tp_infer(synth, mesh, "p2", min_channels=32)
    assert synth.dec is p1.dec is p2.dec and synth.dec is not whole
    kept = {p.data_ptr() for p in synth.parameters()}
    assert not kept & {p.data_ptr() for p in whole.parameters()}
    with pytest.raises(ValueError, match="another mesh"):
        make_tp_infer(synth, Mesh(1, 2, 1, torch.device("cpu"), "gloo"), min_channels=32)


def test_make_mesh_in_one_process():
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.model_group is None
    assert m.gather(torch.ones(2, 3)).shape == (2, 3)
    with pytest.raises(ValueError, match="1x2 != 1"):
        make_mesh(data=1, model=2, device="cpu")


# ---------------------------------------------------------------------------
# the output on gloo ranks against JAX
# ---------------------------------------------------------------------------

def _inputs(synth, params):
    """(x, emo, sid) and, through JAX's infer_p1, (attn, m_p, s_p, g, noise):
    numpy, seeded."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, T_X, 16).astype(np.float32)
    emo = rng.randn(1, 1024).astype(np.float32)
    sid = np.array([3], np.int64)
    noise = rng.randn(1, T_Y, 8).astype(np.float32)
    attn = np.asarray(j_infer_path(jnp.full((1, T_X), T_Y // T_X + 1, jnp.float32), T_Y))
    m_p, s_p, logw, g = (np.asarray(a) for a in synth.infer_p1(
        params, jnp.asarray(x), jnp.asarray(emo), jnp.asarray(sid.astype(np.int32))))
    return (x, emo, sid), (attn, m_p, s_p, g, noise), (m_p, s_p, logw, g)


def _spawn_ranks(tmp_path, world, job):
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=torch_tp_rank.tp_call,
                         args=(r, world, str(tmp_path / "store"), job, str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    assert not alive, f"{len(alive)} rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
    return res


CASES = {  # name: (resblock, weight-normed training tree, world, model)
    "rb2-serving-1x2": ("2", False, 2, 2),
    "rb2-training-1x4": ("2", True, 4, 4),
    "rb1-serving-2x2": ("1", False, 4, 2),
    "rb1-training-1x2": ("1", True, 2, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_infer_p2_matches_jax(tmp_path, case):
    resblock, training, world, model = CASES[case]
    cfg = _cfg(resblock)
    synth = JSynth(**cfg)
    params = jax.tree_util.tree_map(np.asarray, synth.init_params(jax.random.PRNGKey(0)))
    _, p2_args, _ = _inputs(synth, params)
    ref = np.asarray(synth.infer_p2(params, *map(jnp.asarray, p2_args)))

    mesh = jmesh.make_mesh(data=8 // model, model=model)
    specs = jmesh.generator_param_specs(params, mesh, min_channels=32)
    rep = NamedSharding(mesh, P())
    fn = jax.jit(lambda p, a, m, s, g, n: synth.infer_p2(p, a, m, s, g, n),
                 in_shardings=(specs, rep, rep, rep, rep, rep), out_shardings=rep)
    sp = jax.tree_util.tree_map(jax.device_put, params, specs)
    jax_tp = np.asarray(fn(sp, *map(jnp.asarray, p2_args)))

    job = {"params": params, "synth": _cfg(resblock, serving=not training),
           "weight_norm": training, "model": model, "phase": "p2", "min_channels": 32,
           "args": list(p2_args)}
    res = _spawn_ranks(tmp_path, world, job)
    outs = [r["out"][0] for r in res]
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    assert outs[0].shape == ref.shape == (1, T_Y * 8, 1)
    np.testing.assert_allclose(outs[0], ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(outs[0], jax_tp, atol=ATOL, rtol=0)
    assert [r["at"] for r in res] == [divmod(r, model) for r in range(world)]
    assert all(r["backend"] == "gloo" for r in res)
    with torch.device("meta"):
        state = TSynth(**_cfg(resblock, serving=True)).state_dict()
    assert res[0]["sharded"] == sorted(_port_sharded(state, model, 32))
    whole = sum(t.numel() for k, t in state.items() if k.startswith("dec."))
    split = [*res[0]["sharded"], *(k[:-len("weight")] + "bias" for k in res[0]["sharded"])]
    cut = sum(state[k].numel() for k in split if k in state) * (model - 1) // model
    assert all(r["numel"] == r["synth_dec_numel"] == whole - cut for r in res)


def test_tp_infer_p1_matches_jax(tmp_path):
    synth = JSynth(**_cfg())
    params = jax.tree_util.tree_map(np.asarray, synth.init_params(jax.random.PRNGKey(0)))
    (x, emo, sid), _, want = _inputs(synth, params)
    mesh = jmesh.make_mesh(data=4, model=2)
    jax_tp = jmesh.make_tp_infer(synth, mesh, "p1")(
        params, jnp.asarray(x), jnp.ones((1, T_X, 1), jnp.float32), jnp.asarray(emo),
        jnp.asarray(sid.astype(np.int32)))
    job = {"params": params, "synth": _cfg(serving=True), "weight_norm": False, "model": 2,
           "phase": "p1", "min_channels": 32, "args": [x, emo, sid]}
    res = _spawn_ranks(tmp_path, 2, job)
    for r in res:
        assert len(r["out"]) == 4
        for got, ref, jt in zip(r["out"], want, jax_tp):
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
            np.testing.assert_allclose(got, np.asarray(jt), atol=ATOL, rtol=0)
        assert all(np.array_equal(a, b) for a, b in zip(r["out"], res[0]["out"]))
