"""Process groups and device lists: the port of `clibd_tpu/parallel/mesh.py`
(`:1-160`) to `torch.distributed`.

The JAX package has one `Mesh` with a "data" axis for two layouts, the
devices of one process and processes that span hosts.  The port keeps the
two PyTorch idioms apart:

- one process a card (the reference's own layout, scripts/train_cl.py:
  44-48): training, SimCLR, the in-training eval, `eval` and `extract` run
  one rank a card under `torchrun`.  `maybe_initialize_distributed` reads
  torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
  MASTER_PORT) and starts the default group; `create_mesh()` then holds
  this rank's card, the group, the rank and the world size.  XLA's
  collectives inside the jitted step become explicit calls: the
  contrastive loss gathers features with `all_gather_with_grad`, the
  gradients meet in `all_reduce_grads`;
- a list of local devices in one process: the kNN search and the serving
  gallery (`local_mesh()`, or any list, which may name one card twice).

The backend follows the device the caller asks for, NCCL for "cuda" and
gloo for "cpu", or gloo where the caller names it; it is never chosen by
what the process happens to find.  NCCL takes tensors on the card only, so
the helpers move a host tensor (labels, a flag) there for the call; gloo
takes a tensor where it lies: its all_gather and all_reduce take CUDA
tensors (checked on an H100 by `chip_smoke.py` phase 20), so nothing is
copied through the host for it here.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"  # the JAX mesh's one axis: a Mesh shards along it

_MULTIHOST_ENV_HINTS = (
    "CLIBD_MULTIHOST",  # explicit opt-in
    "WORLD_SIZE",       # set by torchrun for every rank
)


def free_port() -> int:
    """A free TCP port on localhost, for MASTER_PORT of ranks started here."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device | str) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(device: torch.device | str = "cuda",
                                 backend: Optional[str] = None) -> bool:
    """Start the default process group from torchrun's environment, once per
    process, before the device is first used (the reference's ddp_setup,
    train_cl.py:44-48).  Only where the environment carries WORLD_SIZE or
    CLIBD_MULTIHOST, so a plain single-process run never waits on a
    rendezvous; CLIBD_DISABLE_DISTRIBUTED turns it off.  For a card it
    selects cuda:LOCAL_RANK before the group starts.  backend: None follows
    `device` (`backend_for`); "gloo" puts the ranks' collectives through
    the host.  → whether a group is active after the call."""
    if os.environ.get("CLIBD_DISABLE_DISTRIBUTED"):
        return False
    if dist.is_initialized():
        return True
    if not any(os.environ.get(k) for k in _MULTIHOST_ENV_HINTS):
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or backend_for(device), init_method="env://",
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return True


def host_id() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Gate for checkpoint saves and file writes: the reference's rank-0
    checks (train_cl.py:264-331)."""
    return host_id() == 0


@dataclass
class Mesh:
    """The devices a computation spans, and the process group when it spans
    ranks.  A rank's mesh (`group` set) holds this rank's card; a local
    mesh (`group` None) lists devices of this process."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None  # a torch.distributed process group
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """Shards along the data axis: the ranks, or the listed devices."""
        return self.world_size if self.group is not None else len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _resolve(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def create_mesh(devices: Optional[Sequence] = None, device: torch.device | str = "cuda") -> Mesh:
    """devices given: a local mesh over them.  Otherwise, in a process
    group, this rank's mesh over the default group (its card: the current
    CUDA device for "cuda"); outside one, `device` alone."""
    if devices is not None:
        return Mesh(tuple(torch.device(d) for d in devices))
    if dist.is_initialized():
        return Mesh((_resolve(device),), dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    return Mesh((torch.device(device),))


def local_mesh(device_type: str = "cuda") -> Mesh:
    """A mesh over this process's devices of one type: every card, or the CPU."""
    if device_type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        if not devices:
            raise RuntimeError("local_mesh('cuda'): no CUDA device")
    else:
        devices = (torch.device(device_type),)
    return Mesh(devices)


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans more than one rank."""
    return mesh.group is not None and mesh.world_size > 1


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _comm_device(group, where: torch.device) -> torch.device:
    """Where the group's collectives take a tensor that lies on `where`: the
    current card for NCCL, where it lies for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return where


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """t on the device the group's backend takes it on (a copy where it is
    not there already)."""
    return t.to(_comm_device(group, t.device)).contiguous()


def all_hosts_agree(flag: bool, group=None) -> bool:
    """True only when every rank passes True (one process: the flag).  Use
    for a branch whose arms hold collectives: a per-rank check of the disk
    must not send ranks down different arms, or the first collective one
    side never joins hangs them all."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device(group, torch.device("cpu")))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def _flatten(tree, leaves: list):
    """(structure, leaves): nests of dicts (keys sorted, as jax.tree does),
    lists and tuples."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], leaves) for k in keys])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, None, [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return ("leaf", None, len(leaves) - 1)


def _unflatten(struct, leaves: list):
    kind, keys, children = struct
    if kind == "leaf":
        return leaves[children]
    if kind == "dict":
        return {k: _unflatten(c, leaves) for k, c in zip(keys, children)}
    items = [_unflatten(c, leaves) for c in children]
    return tuple(items) if kind == "tuple" else items


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, (bool, np.bool_)):
        return torch.tensor(bool(leaf))
    if isinstance(leaf, (int, np.integer)):
        return torch.tensor(int(leaf), dtype=torch.int64)
    if isinstance(leaf, (float, np.floating)):
        return torch.tensor(float(leaf), dtype=torch.float64)
    raise TypeError(f"broadcast_from_main: unsupported leaf {type(leaf).__name__}")


def _restore(like, t: torch.Tensor):
    """t in the type of the leaf it replaces."""
    if isinstance(like, torch.Tensor):
        return t.to(like.device).view(like.shape)
    if isinstance(like, np.ndarray):
        return t.cpu().numpy().reshape(like.shape)
    if isinstance(like, (bool, np.bool_)):
        return bool(t.item())
    if isinstance(like, (int, np.integer)):
        return int(t.item())
    return float(t.item())


def broadcast_from_main(tree, group=None):
    """Rank 0's nest of tensors, numpy arrays and Python numbers to every
    rank (one process: the nest as it is).  Structure, shapes and dtypes
    must match across ranks; each rank gets leaves of the types it passed,
    tensors on the devices they were on.  One broadcast per dtype: the
    leaves of a dtype travel packed in one buffer (on the card for NCCL,
    on the host for gloo, where numpy leaves already are)."""
    if not dist.is_initialized():
        return tree
    leaves: list = []
    struct = _flatten(tree, leaves)
    tensors = [_as_tensor(leaf) for leaf in leaves]
    out = [None] * len(leaves)
    device = _comm_device(group, torch.device("cpu"))
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        buf = torch.cat([tensors[i].reshape(-1).to(device) for i in idx])
        dist.broadcast(buf, src=src, group=group)
        for i, part in zip(idx, buf.split([tensors[i].numel() for i in idx])):
            out[i] = _restore(leaves[i], part.clone())
    return _unflatten(struct, out)


def all_gather_tensor(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (same shape on all) concatenated along axis 0 in rank
    order, without a gradient (`lax.all_gather(tiled=True)`)."""
    if not dist.is_initialized():
        return x
    staged = _staged(x.detach(), group)
    parts = [torch.empty_like(staged) for _ in range(_world(group))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts).to(x.device)


class _AllGatherWithGrad(torch.autograd.Function):
    """Forward: `all_gather_tensor`.  Backward: the incoming gradient summed
    over the ranks, this rank's rows kept (`lax.all_gather`'s transpose,
    `psum_scatter`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(_comm_device(ctx.group, grad.device), copy=True).contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        lo = _rank(ctx.group) * ctx.rows
        return g[lo:lo + ctx.rows].to(grad.device), None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """All ranks' x along axis 0, differentiable: rank r's rows of the
    gradient that reaches x are the sum over ranks of the gradient at those
    rows of the gathered tensor.  So where every rank computes the same loss
    L of the gathered rows, x's gradient is W * dL/dx.  One process: x."""
    if not dist.is_initialized():
        return x
    return _AllGatherWithGrad.apply(x, group)


def all_reduce_grads(params, op: str = "mean", group=None) -> None:
    """Sum ("sum") or average ("mean") each parameter's `.grad` over the
    ranks, in place, packed into one buffer a dtype (DDP's all-reduce).
    Parameters without a gradient are left out; every rank must hold
    gradients for the same ones."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    world = _world(group)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        buf = _staged(torch.cat([g.reshape(-1) for g in same]), group)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if op == "mean":
            buf /= world
        for g, part in zip(same, buf.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over the ranks (`lax.pmean`), without a gradient."""
    if not dist.is_initialized():
        return x
    t = _staged(x.detach().clone(), group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return (t / _world(group)).to(x.device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of every array of a nest of dicts to a multiple,
    repeating the last row → (padded batch, original length)."""
    n = _leading(batch)
    pad = (-n) % multiple

    def _pad(x):
        if pad == 0:
            return x
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")

    return _tree_map(_pad, batch), n


def local_shard(mesh: Mesh, batch):
    """This rank's block of a global batch (a nest of dicts of arrays or
    tensors): rows [r * n/W, (r + 1) * n/W), as `shard_batch` lays a batch
    over the data axis.  n must divide by W."""
    n, w = _leading(batch), mesh.size
    if n % w:
        raise ValueError(f"batch of {n} rows does not divide over {w} ranks")
    lo = mesh.rank * (n // w)
    return _tree_map(lambda x: x[lo:lo + n // w], batch)
