"""Megatron tensor parallelism over the model group (port of the 'model' axis
of mde_tpu/parallel/mesh.py).

The JAX package annotates its parameters with GSPMD specs
(``tp_param_spec``) and lets XLA insert the collectives. The port writes
them out, one ``torch.autograd.Function`` a collective, over
``distributed.model_group()``:

- ``copy_to_model``: identity forward, all-reduce backward (the input of a
  column layer: each rank's share of the input gradient is a partial sum);
- ``reduce_from_model``: all-reduce forward, identity backward (the output of
  a row layer);
- ``gather_from_model``: all-gather on the last dim forward, this rank's
  slice of the gradient backward (the gradient it receives is the same on
  every rank).

``ColumnParallelLinear`` holds a block of a Linear's output features (and
of its bias), ``RowParallelLinear`` a block of its input features, and adds
its whole bias once, after the reduce. ``tensor_parallel(model, T)`` swaps
the Linears that ``parallel.mesh.tp_layout`` shards for these, in place,
with this rank's share of their weights, cuts an attention's per-head
parameters (bias tables, logit scales, q and v biases) to this rank's
heads, and keeps the parameter names: a rank's state_dict is the reference
grammar at the sharded shapes. ``shard_state_dict`` and
``gather_state_dict`` map between the full state_dict and the ranks'
shares; a fused ``qkv`` weight (3 H D, C) is viewed as (3, H D, C) and rank
r takes heads [r H / T, (r + 1) H / T) of each of q, k and v, so that its
share is again a fused (3 (H / T) D, C) weight; a bias table (offsets, H)
gives rank r the same heads on its last dim. Gathering inverts this bit
for bit. An attention that calls ``F.linear`` on its column layer's weight
itself (BEiT's and Swin V2's fused q/v bias) wraps the input in
``copy_to_model`` as the layer would, so that the input's gradient is the
sum over the ranks' heads.

A replicated computation is not bitwise deterministic on a card (cuDNN's
algorithms and ``F.interpolate``'s backward add with atomics), so the model
ranks' copies of a replicated parameter's gradient, and of BatchNorm's
running statistics, can differ in their last bits, and the replicated
parameters would drift apart. ``sync_replicated`` gives every model rank
model rank 0's (one broadcast a type a step), and ``from_model_rank0`` its
step's losses. The JAX package runs one program under GSPMD and needs
neither.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as tdist
import torch.nn as nn
import torch.nn.functional as F

from . import distributed as dist

# Fused projections: their output features are this many blocks (q, k, v),
# each split over the ranks on its own.
FUSED_BLOCKS = {"qkv": 3}


class TPShare(NamedTuple):
    """What ``tensor_parallel`` did to a model: T, this rank's model index,
    and the layout (each state_dict key: "column", "row", "heads" or
    "replicated", ``parallel.mesh.tp_layout``)."""
    size: int
    rank: int
    layout: dict


def _active() -> bool:
    return dist.model_count() > 1


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    tdist.all_reduce(out, group=dist.model_group())
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.model_count())]
        tdist.all_gather(parts, x, group=dist.model_group())  # the list form: gloo has it on CUDA
        ctx.width = x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, dist.model_index() * ctx.width, ctx.width).contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x) if _active() else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x) if _active() else x


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    return _GatherFromModel.apply(x) if _active() else x


def scatter_to_model(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last dim of ``x``, which every rank holds
    whole: the slice forward; backward, the ranks' zero-padded slices of the
    gradient summed (``copy_to_model``), so that the gradient of ``x`` is
    whole on every rank again."""
    if not _active():
        return x
    width = x.shape[-1] // dist.model_count()
    return copy_to_model(x).narrow(-1, dist.model_index() * width, width)


class ColumnParallelLinear(nn.Module):
    """This rank's block of a Linear's output features: ``weight`` (out / T,
    in), ``bias`` (out / T) or None. Input whole, output this rank's block."""

    def __init__(self, weight: torch.Tensor, bias):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        return F.linear(copy_to_model(x), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's block of a Linear's input features: ``weight`` (out, in / T)
    and the whole ``bias`` (out), added once after the ranks' partial
    products are summed, in their type (bf16 under autocast). Input this
    rank's block, output whole."""

    def __init__(self, weight: torch.Tensor, bias):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight))
        return y if self.bias is None else y + self.bias.to(y.dtype)


def split_dim(key: str, kind: str, ndim: int) -> tuple[int, int]:
    """(dim of the torch tensor split, blocks it is viewed as) for a key of
    ``kind`` (``parallel.mesh.tp_layout``) and ``ndim`` dims: "column" splits
    dim 0, a fused projection's block by block; "row" dim 1; "heads" the
    last dim (a bias table's heads)."""
    if kind == "column":
        module = key.rsplit(".", 2)[-2] if key.count(".") else ""
        return 0, FUSED_BLOCKS.get(module, 1)
    if kind == "row":
        return 1, 1
    if kind == "heads":
        return ndim - 1, 1
    raise ValueError(f"{key}: unknown tensor-parallel kind {kind!r}")


def shard_tensor(t: torch.Tensor, key: str, kind: str, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s share of ``t`` (a copy), or ``t`` if ``kind`` is
    "replicated"."""
    if kind == "replicated":
        return t
    dim, blocks = split_dim(key, kind, t.dim())
    v = t.unflatten(dim, (blocks, -1))
    per = v.shape[dim + 1] // size
    if per * size != v.shape[dim + 1]:
        raise ValueError(f"{key}: {tuple(t.shape)} does not split over {size} ranks")
    return v.narrow(dim + 1, rank * per, per).flatten(dim, dim + 1).clone()


def gather_tensor(shares: list, key: str, kind: str) -> torch.Tensor:
    """The whole tensor from the ranks' shares, in rank order."""
    if kind == "replicated":
        return shares[0]
    dim, blocks = split_dim(key, kind, shares[0].dim())
    return torch.cat([s.unflatten(dim, (blocks, -1)) for s in shares],
                     dim=dim + 1).flatten(dim, dim + 1)


def shard_state_dict(state_dict: dict, layout: dict, size: int, rank: int) -> dict:
    """Rank ``rank``'s share of the full reference-grammar ``state_dict``
    under ``layout`` (keys it does not name stay whole)."""
    return {k: shard_tensor(v, k, layout.get(k, "replicated"), size, rank)
            for k, v in state_dict.items()}


def gather_state_dict(shares: list, layout: dict) -> dict:
    """The full state_dict from the T ranks' shares (rank order)."""
    return {k: gather_tensor([s[k] for s in shares], k, layout.get(k, "replicated"))
            for k in shares[0]}


def all_gather_tensor(t: torch.Tensor, key: str, kind: str) -> torch.Tensor:
    """The whole tensor from every rank's share, on every rank of the model
    group (collective over it when ``kind`` is sharded)."""
    if kind == "replicated" or not _active():
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.model_count())]
    tdist.all_gather(parts, t, group=dist.model_group())
    return gather_tensor(parts, key, kind)


def share_of(model: nn.Module):
    """The ``TPShare`` of a model ``tensor_parallel`` converted, else None."""
    return getattr(model, "tp_share", None)


def full_state_dict(model: nn.Module, tensors: dict = None) -> dict:
    """``tensors`` (by default the model's state_dict; or e.g. its gradients
    by parameter name) gathered to the full reference grammar, detached on
    the model's device: collective over the model group for a model
    ``tensor_parallel`` converted, so every rank of that group calls it."""
    tensors = model.state_dict() if tensors is None else tensors
    share = share_of(model)
    if share is None:
        return {k: v.detach() for k, v in tensors.items()}
    return {k: all_gather_tensor(v, k, share.layout.get(k, "replicated"))
            for k, v in tensors.items()}


def parameter_names(model: nn.Module, optimizer) -> list:
    """The names of ``optimizer``'s parameters, in its state_dict's order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _map_moments(state: dict, names: list, fn) -> dict:
    """``state`` (an optimizer state_dict) with each parameter's moment
    tensors (those of the parameter's shape or share) mapped by
    ``fn(tensor, name)``; the step and the groups unchanged."""
    out = {"param_groups": state["param_groups"], "state": {}}
    for i, entry in state["state"].items():
        out["state"][i] = {k: fn(v, names[int(i)]) if torch.is_tensor(v) and v.dim() else v
                           for k, v in entry.items()}
    return out


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """``optimizer.state_dict()`` with AdamW's moments gathered by parameter
    name to the full shapes (collective over the model group for a
    converted model); the one-process optimizer's state_dict."""
    state = optimizer.state_dict()
    share = share_of(model)
    if share is None:
        return state
    return _map_moments(state, parameter_names(model, optimizer),
                        lambda v, n: all_gather_tensor(v, n, share.layout.get(n, "replicated")))


def shard_optimizer_state(model: nn.Module, optimizer, state: dict) -> dict:
    """A full optimizer state_dict (``full_optimizer_state``'s) cut to this
    rank's share of a converted model, by parameter name."""
    share = share_of(model)
    if share is None:
        return state
    return _map_moments(state, parameter_names(model, optimizer),
                        lambda v, n: shard_tensor(v, n, share.layout.get(n, "replicated"),
                                                  share.size, share.rank))


def tensor_parallel(model: nn.Module, size: int) -> nn.Module:
    """Give ``model`` this process's share of every part ``parallel.mesh.
    tp_layout`` shards over ``size`` ranks (the model axis
    ``distributed.set_model_axis`` made), in place, and record the
    ``TPShare`` as ``model.tp_share``. Returns ``model``.

    The layout shards only what a module declares (``parallel.mesh.
    declared_parts``): a Linear of its ``tp_linears`` (the ViT, BEiT, Swin
    and Next-ViT attention, the MLP, the flagship's cross-attention, Swin
    V2's position-bias MLP) becomes a ``ColumnParallelLinear`` /
    ``RowParallelLinear``; a parameter of its ``tp_heads`` (a bias table, a
    logit scale, BEiT's and V2's q and v biases) becomes its share, a new
    ``nn.Parameter`` under the same name. A model the layout leaves whole
    (the CNNs, LeViT) is unchanged.
    """
    from .mesh import tp_layout

    if dist.model_count() != size:
        raise ValueError(f"tensor_parallel over {size} ranks in a model axis of "
                         f"{dist.model_count()} (distributed.set_model_axis)")
    rank = dist.model_index()
    layout = tp_layout(model, size)
    modules = dict(model.named_modules())
    linears, params = {}, []
    for key, kind in layout.items():
        if kind == "replicated":
            continue
        path = key.rsplit(".", 1)[0]
        if type(modules[path]) is nn.Linear:
            linears[path] = layout[f"{path}.weight"]
        else:
            params.append(key)
    for key in params:
        path, _, name = key.rpartition(".")
        t = getattr(modules[path], name)
        share = shard_tensor(t.detach(), key, layout[key], size, rank).clone()
        setattr(modules[path], name, nn.Parameter(share, requires_grad=t.requires_grad))
    for path, kind in linears.items():
        owner_path, _, child = path.rpartition(".")
        linear = modules[path]
        weight, bias = (None if t is None else
                        shard_tensor(t.detach(), f"{path}.{name}", layout[f"{path}.{name}"],
                                     size, rank).clone()
                        for name, t in (("weight", linear.weight), ("bias", linear.bias)))
        cls = ColumnParallelLinear if kind == "column" else RowParallelLinear
        setattr(modules[owner_path], child,
                cls(weight, bias).requires_grad_(linear.weight.requires_grad))
    model.tp_share = TPShare(size, rank, layout)
    return model


def broadcast_from_model_rank0(tensors: list) -> None:
    """Overwrite each of ``tensors`` in place with model rank 0's copy, over
    the model group: one flat broadcast a dtype."""
    if not _active() or not tensors:
        return
    src = dist.process_index() - dist.model_index()  # its data index's model rank 0
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            tdist.broadcast(flat, src=src, group=dist.model_group())
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def sync_replicated(model: nn.Module) -> None:
    """Model rank 0's gradients of the parameters every model rank holds
    whole, and its floating buffers (BatchNorm's running statistics), on
    every model rank of a converted ``model`` (module docstring)."""
    share = share_of(model)
    if share is None or not _active():
        return
    grads = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and share.layout.get(n, "replicated") == "replicated"]
    broadcast_from_model_rank0(grads + [b for b in model.buffers() if b.is_floating_point()])


def from_model_rank0(values: dict) -> dict:
    """``values`` (0-d tensors of one type) as model rank 0 holds them, on
    every model rank."""
    if not _active():
        return values
    flat = torch.stack(list(values.values()))
    broadcast_from_model_rank0([flat])
    return dict(zip(values, flat.unbind()))


def parameter_bytes(model: nn.Module) -> int:
    """The bytes of the parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def predicted_parameter_bytes(model: nn.Module, layout: dict, size: int) -> int:
    """The bytes a rank holds under ``layout``, from the whole ``model``: a
    sharded parameter's over ``size``, the rest whole."""
    return sum(p.numel() * p.element_size()
               // (1 if layout.get(n, "replicated") == "replicated" else size)
               for n, p in model.named_parameters())
