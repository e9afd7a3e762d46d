"""Data-parallel training over torch.distributed: the counterpart of the
data half of vits_tpu/parallel/mesh.py (the batch sharded over `data`,
state replicated, GSPMD's gradient all-reduce), as the reference trains:
one process per card (train.py:29-50,116-118), launched by torchrun.

Rank r of W drives `cuda:LOCAL_RANK` and takes its own batch of
`batch_size` utterances from the rank-strided `BucketSampler`; the global
batch is W x batch_size. The training step (`train/step.py`) makes each
rank's loss its share of the JAX loss on the global batch, so that the sum
of the rank gradients, one coalesced all-reduce per optimizer, is the
gradient of that loss; every rank then applies the same update, and the
replicas stay bit-equal with no further synchronisation.

The backend is a rule on the topology (`pick_backend`): NCCL when every
rank on the host has a card of its own, gloo on the CPU and when ranks share
a card (NCCL refuses two ranks on one device). Only all_reduce and
broadcast are used here: torch's documentation lists only those two for
gloo on CUDA tensors (on the card gloo takes all_gather too, which
`parallel/mesh.py` uses).

Every function is a plain function on tensors and a no-op in one process
(`group` None or a world of one).
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from vits_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
# the seed stride between ranks' noise and dropout generators (a prime, so
# that rank r's streams never meet another seed of the same run)
RANK_SEED_STRIDE = 1_000_003


class DistInfo(NamedTuple):
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: Optional[str]  # None in one process

    @property
    def group(self):
        """The process group of the step's collectives: None in one process."""
        return dist.group.WORLD if self.world > 1 else None


def pick_backend(device: torch.device, ranks_per_card: int) -> str:
    """NCCL when the ranks run on cards, one rank a card; gloo on the CPU and
    when ranks share a card."""
    return "nccl" if device.type == "cuda" and ranks_per_card == 1 else "gloo"


def _rank_device(device, local_rank: int, ranks_on_host: int):
    """(the rank's device, ranks per card). A bare "cuda" (or None) means
    `cuda:LOCAL_RANK`, wrapped over the host's cards when there are more
    ranks than cards; an explicit `cuda:k` is every rank's card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, 0
    if dev.index is not None:
        return dev, ranks_on_host
    cards = torch.cuda.device_count()
    return torch.device("cuda", local_rank % cards), math.ceil(ranks_on_host / cards)


def _describe(backend: str, device: torch.device, world: int, ranks_per_card: int) -> str:
    if device.type != "cuda":
        return f"backend {backend}: {world} ranks on the cpu"
    if ranks_per_card > 1:
        return f"backend {backend}: {ranks_per_card} ranks share 1 card"
    return f"backend {backend}: {world} ranks, one card each"


def init_distributed(device=None, backend: Optional[str] = None) -> DistInfo:
    """The process's place in the run, from the environment torchrun sets
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), with the default process group initialised. A group the
    caller has initialised already is used as it is. `device` is the
    training device as the CLI gives it (None or "cuda": the rank's card;
    "cpu"); `backend` None takes `pick_backend`'s, and an explicit "nccl"
    that the rule refuses (on the CPU, ranks sharing a card) raises. One
    process (WORLD_SIZE unset or 1, no group): rank 0 of 1 on
    `resolve_device(device)`, no group."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    initialised = initialized()
    world = dist.get_world_size() if initialised else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return DistInfo(0, 1, 0, resolve_device(device), None)
    if not initialised:
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"WORLD_SIZE={world} without {', '.join(missing)} in the environment and "
                "no process group: launch the ranks with torchrun (python -m "
                "torch.distributed.run --nproc_per_node N -m vits_tpu_torch.train ...)")
    rank = dist.get_rank() if initialised else int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev, per_card = _rank_device(device, local_rank, ranks_on_host)
    rule = pick_backend(dev, per_card)
    chosen = dist.get_backend() if initialised else (backend or rule)
    if chosen == "nccl" and rule != "nccl":
        where = "on the cpu" if dev.type != "cuda" else f"with {per_card} ranks on one card"
        raise ValueError(f"NCCL {where} is refused: NCCL needs one card per rank; "
                         "gloo is the backend there")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not initialised:
        dist.init_process_group(chosen, init_method="env://", rank=rank, world_size=world)
        if rank == 0:
            print(_describe(chosen, dev, world, per_card), flush=True)
    return DistInfo(rank, world, local_rank, dev, chosen)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def initialized() -> bool:
    """Whether this process has a default process group."""
    return dist.is_available() and dist.is_initialized()


def is_main() -> bool:
    """Rank 0, or the only process: the process group's rank, else RANK as
    torchrun sets it before there is a group."""
    rank = dist.get_rank() if initialized() else int(os.environ.get("RANK", "0"))
    return rank == 0


def shutdown():
    """Destroy the default process group, where there is one."""
    if initialized():
        dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s noise or dropout generator: `seed` itself on
    rank 0, so that one process draws what it always drew."""
    return seed + RANK_SEED_STRIDE * rank


def _coalesced(tensors: List[torch.Tensor], device: torch.device, op):
    """Apply the collective `op(flat)` to `tensors` as one flat buffer on
    `device` per dtype, and copy the result back into each tensor."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        op(flat)
        parts = flat.split([t.numel() for t in ts])
        with torch.no_grad():
            torch._foreach_copy_(ts, [p.view_as(t) for p, t in zip(parts, ts)])


def allreduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum every parameter's gradient over the ranks in one all-reduce (per
    dtype). A parameter without one gets a zero gradient first, as
    `Optimizer.update` would give it, so every rank reduces the same
    layout."""
    if world_size(group) == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    _coalesced(grads, grads[0].device,
               lambda flat: dist.all_reduce(flat, dist.ReduceOp.SUM, group=group))


def global_count(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks, detached: a normaliser of the global batch
    (no gradient flows through it)."""
    if world_size(group) == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return t


def global_std(x: torch.Tensor, group) -> torch.Tensor:
    """The population std of `x` over every rank's cells (jnp.std of the
    global array), in x's dtype; one process: `torch.std(x, correction=0)`.
    The moments are summed in float64, so that the one-pass variance keeps
    float32's precision where the mean is large beside the spread."""
    if world_size(group) == 1:
        return torch.std(x, correction=0)
    xd = x.detach().double()
    s = torch.stack([xd.sum(), torch.square(xd).sum(),
                     torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device)])
    dist.all_reduce(s, dist.ReduceOp.SUM, group=group)
    mean = s[0] / s[2]
    return torch.sqrt(torch.clamp(s[1] / s[2] - mean * mean, min=0.0)).to(x.dtype)


def allreduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Every tensor of `metrics` summed over the ranks, in one all-reduce
    (per dtype): the global values of the step's loss shares. Every rank
    calls it at the same step."""
    if world_size(group) == 1:
        return dict(metrics)
    out = {k: v.detach().clone() for k, v in metrics.items()}
    ts = list(out.values())
    _coalesced(ts, ts[0].device,
               lambda flat: dist.all_reduce(flat, dist.ReduceOp.SUM, group=group))
    return out


def _state_tensors(state) -> List[torch.Tensor]:
    """Every parameter, buffer and optimizer-state tensor of the training
    state, in a fixed order."""
    out = []
    for key in ("gen", "disc", "dur"):
        if key not in state:
            continue
        out += list(state[key].state_dict(keep_vars=True).values())
        opt = state[f"{key}_opt"]
        for group in opt.param_groups:
            for p in group["params"]:
                s = opt.state.get(p, {})
                out += [s[k] for k in sorted(s) if torch.is_tensor(s[k])]
    return out


def broadcast_state(state, group) -> None:
    """Rank 0's parameters, buffers (spectral norm's u) and optimizer states
    onto every rank, in place."""
    if world_size(group) == 1:
        return
    device = next(state["gen"].parameters()).device
    _coalesced(_state_tensors(state), device,
               lambda flat: dist.broadcast(flat, 0, group=group))


def state_digest(state) -> str:
    """sha256 over every parameter and buffer (spectral norm's u) of the
    models in `state`, in state_dict order: equal across the ranks of a
    run whose replicas agree."""
    h = hashlib.sha256()
    for key in ("gen", "disc", "dur"):
        if key in state:
            for name, t in state[key].state_dict().items():
                h.update(name.encode())
                h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replicas_agree(digest: str, group, device: torch.device) -> bool:
    """Whether every rank holds the same `digest` (its sha256 words' MIN and
    MAX over the ranks are its own)."""
    if world_size(group) == 1:
        return True
    words = torch.from_numpy(np.frombuffer(bytes.fromhex(digest), dtype=">i8").astype(np.int64))
    lo, hi = words.to(device), words.to(device)
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(lo, hi) and torch.equal(lo.cpu(), words))
