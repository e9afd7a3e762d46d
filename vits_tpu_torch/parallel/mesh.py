"""Tensor parallelism of the HiFi-GAN decoder over torch.distributed: the
counterpart of the tensor half of vits_tpu/parallel/mesh.py (`make_mesh`,
`generator_param_specs`, `shard_generator_params`, `make_tp_infer`). The
data half (`make_sharded_train_step`, `replicate`, `shard_batch`,
`batch_sharding`, `local_batch_to_global`) is `parallel/dist.py`: each
torchrun rank feeds its own local batch.

The mesh. The ranks torchrun started, rank = d * model + m, form a
(data, model) grid: a `model` group per data index and a `data` group per
model index, each with the backend of `dist.pick_backend`'s rule (NCCL with
a card a rank; gloo on the CPU and when ranks share a card).

The sharding rule is the JAX package's (mesh.py:80-104) in the port's
layouts: a decoder kernel whose output channels number at least
`min_channels` and divide by the model axis's size is split on its output
channels into contiguous slices, rank m of the model axis holding slice m,
as a `NamedSharding` over `model` lays them out; every other tensor (biases,
weight norm's g, the narrow stages, conv_post, everything outside the
decoder) stays replicated. The JAX kernels keep C_out last; the port's
output dim is 0 for a Conv1d weight (C_out, C_in, k) and a Dense weight
(C_out, C_in), and 1 for a ConvTranspose1d weight (C_in, C_out, k).

The computation. GSPMD chose the JAX package's collectives; the port's are
explicit and exact. Each sharded layer computes its slice of output
channels from its whole (replicated) input with its slice of the bias, and
one gather over the model group restores every channel, so everything
between two sharded layers (the GLU gate, whose tanh and sigmoid halves lie
on different ranks at model 2, the residual adds, the masks) runs
replicated on the full tensor, and every rank ends with the full output.
The gather is one `all_gather` of the slices, over NCCL or gloo: gloo takes
CUDA tensors for it too (through the host; checked on the card, where
torch's documentation lists only all_reduce and broadcast for gloo on
CUDA).

Weight norm crosses the shards (a ConvTranspose1d's g normalises each
input channel over every output channel), so a weight-normed model is
folded on whole tensors first (`fold_module_weight_norm`) and sliced
after. Tensor parallelism is float only, as the JAX package's
`make_tp_infer` runs the float `infer_p2`: the int8 paths of a sharded
decoder raise.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as tdist
from torch import nn

from vits_tpu_torch.convert import _is_transposed
from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.nn.core import Conv1d, ConvTranspose1d, Dense, fold_module_weight_norm
from vits_tpu_torch.parallel import dist

MIN_CHANNELS = 128  # the JAX rule's default


class Mesh:
    """This rank's place in a (data, model) grid of the ranks: `shape`
    {"data": D, "model": M}, its indices on both axes, the process groups
    of its row (`model_group`) and column (`data_group`), None in a group
    of one, their `backend`, and the rank's `device`."""

    def __init__(self, data: int, model: int, rank: int, device: torch.device,
                 backend: Optional[str], model_group=None, data_group=None):
        self.shape = {"data": data, "model": model}
        self.rank, self.device, self.backend = rank, device, backend
        self.data_index, self.model_index = divmod(rank, model)
        self.model_group, self.data_group = model_group, data_group

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last (channel) axis of y, `model`
        slices in all, gathered over the model group into the full tensor,
        slice m from model rank m, on every rank."""
        if self.shape["model"] == 1:
            return y
        y = y.contiguous()  # a collective sends the storage
        parts = [torch.empty_like(y) for _ in range(self.shape["model"])]
        tdist.all_gather(parts, y, group=self.model_group)
        return torch.cat(parts, dim=-1)

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank "
                f"{self.rank} at ({self.data_index}, {self.model_index}), {self.device}, "
                f"{self.backend})")


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over every rank of the default process group
    (torchrun's; `dist.init_distributed` makes it), all on the data axis by
    default. `device` as the CLIs take it (None or "cuda": the rank's card,
    `cuda:LOCAL_RANK` wrapped over the host's cards; "cpu"). Every rank
    calls it, with the same sizes. One process without a group: a mesh of
    one rank."""
    world = tdist.get_world_size() if dist.initialized() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} ranks")
    if world == 1:
        return Mesh(1, 1, 0, resolve_device(device), None)
    rank = tdist.get_rank()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev, per_card = dist._rank_device(device, local_rank,
                                      int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    backend = dist.pick_backend(dev, per_card)
    # every rank creates every group of more than one rank, in the same order
    rows = [tdist.new_group(list(range(d * model, (d + 1) * model)), backend=backend)
            for d in range(data)] if model > 1 else None
    cols = [tdist.new_group(list(range(m, world, model)), backend=backend)
            for m in range(model)] if data > 1 else None
    d, m = divmod(rank, model)
    return Mesh(data, model, rank, dev, backend, rows and rows[d], cols and cols[m])


def _axis_size(mesh_or_size: Union[Mesh, int]) -> int:
    return mesh_or_size if isinstance(mesh_or_size, int) else mesh_or_size.shape["model"]


def _out_dim(key: str, shape) -> Optional[int]:
    """The output-channel dim of a kernel tensor of the state dict (a plain
    `weight` or weight norm's `weight_v`), or None for any other tensor."""
    parts = key.split(".")
    if parts[-1] not in ("weight", "weight_v") or len(shape) < 2:
        return None
    return 1 if _is_transposed(tuple(parts[:-1])) else 0


def generator_param_specs(state, mesh_or_size: Union[Mesh, int],
                          min_channels: int = MIN_CHANNELS) -> Dict[str, Optional[int]]:
    """{key: the dim it is split on over the model axis, or None} for every
    tensor of `state` (a synthesizer's state dict, or the module): a
    decoder ("dec") kernel whose output channels divide by the axis's size
    and number at least `min_channels` is split on them; all else is
    replicated. The JAX rule (vits_tpu/parallel/mesh.py:80) on the same
    tree selects the same tensors (tests/test_torch_tp.py)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    size = _axis_size(mesh_or_size)
    specs = {}
    for key, t in state.items():
        dim = None
        if size > 1 and "dec" in key.split(".")[:-1]:
            dim = _out_dim(key, t.shape)
            if dim is not None and (t.shape[dim] % size or t.shape[dim] < min_channels):
                dim = None
        specs[key] = dim
    return specs


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.shape["model"]
    return t.narrow(dim, mesh.model_index * n, n).clone()


def shard_generator_params(mesh: Mesh, state, min_channels: int = MIN_CHANNELS
                           ) -> Dict[str, torch.Tensor]:
    """This rank's tensors of `state` (a state dict, or the module): its
    contiguous slice of each tensor `generator_param_specs` splits, as a
    `NamedSharding` over `model` lays it out, and every other tensor
    whole."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    specs = generator_param_specs(state, mesh, min_channels)
    return {k: t if specs[k] is None else _slice(t, specs[k], mesh) for k, t in state.items()}


class ShardedLayer(nn.Module):
    """A folded Conv1d, ConvTranspose1d or Dense of the decoder split on its
    output channels: `layer` is the layer itself, its kernel and bias
    narrowed in place to this rank's slice. `forward` takes the layer's
    whole input and returns its whole output: the layer's slice of the
    channels, gathered over the model group."""

    def __init__(self, layer: nn.Module, dim: int, mesh: Mesh):
        super().__init__()
        if layer.weight_norm or layer.spectral_norm:
            raise ValueError("a normed kernel is folded before it is split")
        if getattr(layer, "groups", 1) != 1:
            raise ValueError("a grouped Conv1d is not split on its output channels")
        layer.weight = nn.Parameter(_slice(layer.weight.detach(), dim, mesh), requires_grad=False)
        if layer.bias is not None:
            layer.bias = nn.Parameter(_slice(layer.bias.detach(), 0, mesh), requires_grad=False)
        setattr(layer, "out_features" if isinstance(layer, Dense) else "out_channels",
                layer.weight.shape[dim])
        self.layer, self.mesh = layer, mesh

    def forward(self, x):
        return self.mesh.gather(self.layer(x))


class TPDecoder(nn.Module):
    """The decoder of `make_tp_infer`: a folded copy of the Generator with
    its sharded layers wrapped in `ShardedLayer`s. Float only: the int8
    entry points raise."""

    def __init__(self, dec: nn.Module, mesh: Mesh, min_channels: int = MIN_CHANNELS):
        super().__init__()
        gen = fold_module_weight_norm(copy.deepcopy(dec)).eval()
        specs = generator_param_specs({f"dec.{k}": v for k, v in gen.state_dict().items()},
                                      mesh, min_channels)
        for name, layer in list(gen.named_modules()):
            dim = specs.get(f"dec.{name}.weight")
            if dim is None:
                continue
            if not isinstance(layer, (Conv1d, ConvTranspose1d, Dense)):
                raise TypeError(f"dec.{name}: a {type(layer).__name__} is not split")
            parent, _, attr = name.rpartition(".")
            setattr(gen.get_submodule(parent), attr, ShardedLayer(layer, dim, mesh))
        gen.pack_fused()  # of the layers as they now are: none where one is sharded
        self.gen, self.mesh = gen, mesh
        self.sharded = sorted(k for k, d in specs.items() if d is not None)

    def forward(self, x, g=None, x_mask=None):
        return self.gen(x, g=g, x_mask=x_mask)

    def _float_only(self, *a, **k):
        raise NotImplementedError("a tensor-parallel decoder is float only: its int8 "
                                  "paths (calibrate, quantize, forward_q8) are refused")

    calibrate = quantize = forward_q8 = _float_only


class TPInfer:
    """`make_tp_infer`'s callable: `phase` "p2" is the synthesizer's
    `infer_p2` (attn, m_p, s_p, g, noise, y_mask=None), which decodes
    through the sharded decoder; "p1" its `infer_p1` (x, emo, sid,
    x_mask=None), which touches no decoder tensor and runs replicated.
    Every rank of the model group calls it with the same inputs and gets the
    full output."""

    def __init__(self, synth, mesh: Mesh, phase: str = "p2",
                 min_channels: int = MIN_CHANNELS):
        if phase not in ("p1", "p2"):
            raise ValueError(f"phase {phase!r}: 'p1' or 'p2'")
        if not isinstance(synth.dec, TPDecoder):
            synth.dec = TPDecoder(synth.dec, mesh, min_channels)
        elif synth.dec.mesh is not mesh:
            raise ValueError("the synthesizer's decoder is split over another mesh")
        self.synth, self.mesh, self.phase, self.dec = synth, mesh, phase, synth.dec

    @torch.no_grad()
    def __call__(self, *args, **kw):
        fn = self.synth.infer_p1 if self.phase == "p1" else self.synth.infer_p2
        return fn(*args, **kw)

    def decoder_numel(self) -> int:
        """Elements of the decoder tensors this rank holds."""
        return sum(p.numel() for p in self.dec.parameters())


def make_tp_infer(synth, mesh: Mesh, phase: str = "p2",
                  min_channels: int = MIN_CHANNELS) -> TPInfer:
    """infer_p1 / infer_p2 of `synth` (a serving or a weight-normed training
    synthesizer on this rank's device) with its decoder split over the mesh's
    model axis: sharded once here (the JAX package re-jits per call), the
    full output on every rank. It takes the synthesizer over: `synth.dec`
    becomes the sharded `TPDecoder`, so the rank holds only its slices of
    the split kernels once nothing else refers to the whole decoder. See the
    module docstring."""
    return TPInfer(synth, mesh, phase, min_channels)
