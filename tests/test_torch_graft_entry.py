"""The port's graft entry points (`vits_tpu_torch/graft_entry.py`) against
the JAX package's __graft_entry__.py on the CPU.

`dryrun_multichip(n, device="cpu")` starts n gloo ranks (spawned, one
intra-op thread each, each joined within the function's own timeout),
prints the JAX dry-run's lines and finishes: every rank the same global
losses, finite; at n = 2 the tensor-parallel decode over a (1, 2) mesh.
No K2 launch on the CPU (MAS takes the plain search there).

`entry()`'s outputs have the shapes and dtypes of JAX's `entry()` under
`jax.eval_shape` (base config; marked slow).
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from vits_tpu_torch import graft_entry


def test_tiny_cfg_is_the_jax_entrys():
    assert graft_entry._tiny_cfg() == __graft_entry__._tiny_cfg()


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_the_cpu(capfd, n):
    res = graft_entry.dryrun_multichip(n, device="cpu")
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith(f"dryrun_multichip({n})")]
    want = [f"dryrun_multichip({n}): {n} rank(s) on cpu, backend {'gloo' if n > 1 else None}",
            f"dryrun_multichip({n}): DP train step OK loss_g_total=",
            f"dryrun_multichip({n}): DP stft/MRD train step OK loss_g_total="]
    if n >= 2:
        want.append(f"dryrun_multichip({n}): TP decoder infer OK wav=(1, 192, 1)")
    assert len(lines) == len(want), out
    assert all(ln.startswith(w) for ln, w in zip(lines, want)), out
    assert [r["rank"] for r in res] == list(range(n))
    for key in ("loss_mel", "loss_stft"):
        assert np.isfinite(res[0][key])
        assert all(r[key] == res[0][key] for r in res)
        assert f"loss_g_total={res[0][key]:.3f}" in out
    assert all(r["k2_launches"] == 0 and r["k2_calls"] == [] for r in res)
    if n >= 2:
        assert all(torch.equal(r["wav"], res[0]["wav"]) for r in res)
        assert all(r["tp_sharded"] == 8 for r in res)


def test_mas_recorded_records_kernel_launches_and_restores(monkeypatch):
    """`ops.mas.recorded` (the dry-run's record of its K2 launches) wraps the
    kernel's wrapper for the block: each launch's inputs and path on the
    host, the wrapper put back afterwards, also when the block raises. The
    kernel is stood in for by the plain search (no card here)."""
    from vits_tpu_torch.ops import mas

    def fake_kernel(neg, t_ys, t_xs):
        return mas.maximum_path_plain(neg, t_ys, t_xs)

    monkeypatch.setattr(mas, "maximum_path_cuda", fake_kernel)
    g = torch.Generator().manual_seed(0)
    neg = torch.randn(2, 9, 4, generator=g)
    ty, tx = torch.tensor([9, 6], dtype=torch.int32), torch.tensor([4, 3], dtype=torch.int32)
    with mas.recorded([]) as calls:
        path = mas.maximum_path_cuda(neg, ty, tx)
        mas.maximum_path(neg, torch.ones(2, 9, 4))  # CPU tensors: the plain search, no launch
    assert mas.maximum_path_cuda is fake_kernel
    assert len(calls) == 1
    for got, want in zip(calls[0], (neg, ty, tx, path)):
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="boom"):
        with mas.recorded([]):
            raise RuntimeError("boom")
    assert mas.maximum_path_cuda is fake_kernel


@pytest.mark.parametrize("n", [0, 3])
def test_dryrun_refuses_a_mesh_it_cannot_build(n):
    """An odd rank count past 1 has no (n // 2, 2) mesh (JAX's make_mesh
    asserts); the dry-run refuses it before it starts a rank."""
    with pytest.raises(ValueError, match="even number"):
        graft_entry.dryrun_multichip(n, device="cpu")


@pytest.mark.slow
def test_entry_outputs_have_the_jax_shapes():
    jfn, jargs = __graft_entry__.entry()
    want = jax.eval_shape(jfn, *jargs)
    fn, args = graft_entry.entry(device="cpu")
    with torch.no_grad():
        got = fn(*args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert torch.isfinite(g).all()
