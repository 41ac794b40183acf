"""Tensor parallelism (Megatron-style) over the ``(data, model)`` mesh
(port of ``mmvae_tpu/parallel/tp.py:109-310``).

The layout is JAX's, decided by the same rules on the same layers:

* **Dense chains** inside each expert (Flax's ``Dense_*``, the port's
  ``layers.*`` and ``head``) alternate column-parallel (the output features
  sharded, the bias too) and row-parallel (the input features sharded, the
  bias replicated) in index order (:func:`chain_assignments`); a layer
  whose dim does not divide replicates, and a trailing column-parallel
  layer is demoted to replicated, so every expert's output leaves
  replicated.
* **Conv chains** (``Conv_*`` and ``ConvTranspose_*``, the port's
  ``convs.*`` and ``deconvs.*``) alternate the same way over channels,
  as a chain of their own. So stage 0 of an RGB encoder is
  column-parallel: a rank runs K4 on its 32 / tp output channels.
* **Attribute banks** (every parameter of the expert shares a leading
  axis that divides the model axis, one of them >= 3-D: CelebA's 18
  attribute experts) shard that axis: each rank owns 18 / tp attribute
  experts end to end.
* Everything else (GRUs, embeddings, trunks) replicates.

The layout is decided in Flax's coordinates and mapped onto the port's
tensors (``convert.flax_axes``: an ``nn.Linear`` weight is Flax's kernel
transposed, a conv's OIHW is HWIO permuted, a transposed conv's ``(in,
out, kh, kw)`` too), so a rank holds the elements of JAX's shard.

GSPMD turns JAX's layout into collectives; here they are explicit,
``torch.autograd.Function``s over the model group that the experts call
(``models/experts.py``): :func:`copy_in` (identity forward, all-reduce
backward) where a replicated activation enters a column-parallel layer,
:func:`reduce_out` (all-reduce forward, identity backward) at a
row-parallel layer's partial product, :func:`gather_out` (all-gather
forward, the rank's own slice backward) where a sharded activation must be
whole (a bank's outputs, a layer or op that reads every channel), and
:func:`split` (the rank's slice forward, all-gather backward) where a
row-parallel layer meets a replicated input. A model built with
``tp_mesh`` (``configs.build_model``) runs that way on the parameters
:func:`tp_shard` leaves each rank; the train step then reduces the
gradient over the data group only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from mmvae_torch.convert import flax_axes
from mmvae_torch.parallel.layout import Layout, all_gather_dim

__all__ = [
    "TPGroup",
    "chain_assignments",
    "expert_kinds",
    "is_bank",
    "tp_param_specs",
    "tp_shard",
    "copy_in",
    "reduce_out",
    "gather_out",
    "split",
]

class TPGroup:
    """The model group of an expert built with ``tp_mesh``: its process
    group, size and this rank's place in it, and whether the expert's
    running activation is channel-sharded (``sharded``, reset at each
    forward). Deep copies share it (the EMA shadow of a TP model runs on
    the same group)."""

    def __init__(self, mesh):
        self.group, self.size, self.rank = mesh.model_group, mesh.model_size, mesh.model_rank
        self.sharded = False

    def __deepcopy__(self, memo):
        return self

    def replicated(self, h: torch.Tensor, dim: int) -> torch.Tensor:
        """``h`` whole: gathered along ``dim`` where it is sharded."""
        if self.sharded:
            h, self.sharded = gather_out(h, self, dim), False
        return h

    def sharded_in(self, h: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``h`` along ``dim`` where it is whole."""
        if not self.sharded:
            h, self.sharded = split(h, self, dim), True
        return h


def chain_assignments(dims: list[tuple[int, int]], n_shards: int) -> list[str]:
    """Col/row/col/... along one layer chain (``tp.py:131-163``):
    ``dims[i] = (col_dim, row_dim)``, the dims a col (output) or row
    (input) sharding of layer ``i`` would split. A layer whose needed dim
    does not divide replicates and the pattern continues on the next
    layer; a trailing ``col`` demotes to ``rep``."""
    out: list[str] = []
    want_col = True
    for col_d, row_d in dims:
        dim = col_d if want_col else row_d
        if dim % n_shards == 0:
            out.append("col" if want_col else "row")
            want_col = not want_col
        else:
            out.append("rep")
    if out and out[-1] == "col":
        out[-1] = "rep"
    return out


def _dense_layers(expert: nn.Module) -> list[tuple[str, nn.Module]]:
    """The expert's Dense chain in Flax's index order: ``layers.0 ..``, then
    ``head`` (Flax's last ``Dense_*``)."""
    out = []
    layers = getattr(expert, "layers", None)
    if isinstance(layers, nn.ModuleList):
        out += [(f"layers.{i}", m) for i, m in enumerate(layers) if isinstance(m, nn.Linear)]
    if isinstance(getattr(expert, "head", None), nn.Linear):
        out.append(("head", expert.head))
    return out


def _conv_layers(expert: nn.Module) -> list[tuple[str, nn.Module]]:
    """The expert's conv chain in the order JAX's ``_dense_specs`` walks it:
    ``Conv_i`` and ``ConvTranspose_i`` sorted by ``(i, Flax name)`` (at one
    index ``ConvTranspose_i`` sorts first, a decoder with both)."""
    found = []
    for attr, flax in (("convs", "Conv"), ("deconvs", "ConvTranspose")):
        for i, m in enumerate(getattr(expert, attr, None) or ()):
            found.append(((i, f"{flax}_{i}"), f"{attr}.{i}", m))
    return [(name, m) for _, name, m in sorted(found, key=lambda f: f[0])]


def _kernel_dims(layer: nn.Module) -> tuple[int, int]:
    """``(col_dim, row_dim)`` of a layer: the sizes of Flax's kernel's
    output and input axes (Dense ``(in, out)``, conv ``(kh, kw, in,
    out)``)."""
    w = layer.weight
    if isinstance(layer, nn.Linear):
        return w.shape[0], w.shape[1]
    if isinstance(layer, nn.Conv2d):
        return w.shape[0], w.shape[1]
    return w.shape[1], w.shape[0]  # ConvTranspose2d: (in, out, kh, kw)


def expert_kinds(expert: nn.Module, n_shards: int) -> dict[str, str]:
    """``"col"``, ``"row"`` or ``"rep"`` for each Dense and conv layer of
    ``expert`` (its module name), as ``_dense_specs`` assigns them: two
    independent chains."""
    kinds = {}
    for chain in (_dense_layers(expert), _conv_layers(expert)):
        dims = [_kernel_dims(m) for _, m in chain]
        kinds.update(zip((n for n, _ in chain), chain_assignments(dims, n_shards)))
    return kinds


def is_bank(expert: nn.Module, n_shards: int) -> bool:
    """A bank (``_is_bank``, ``tp.py:109-128``): parameters of its own and
    no child modules, all sharing one leading axis above 1 that divides
    ``n_shards``, at least one of them >= 3-D."""
    params = list(expert.parameters(recurse=False))
    if not params or any(True for _ in expert.children()):
        return False
    leads = {p.shape[:1] for p in params}
    if len(leads) != 1:
        return False
    (lead,) = leads.pop() or (0,)
    return lead > 1 and lead % n_shards == 0 and any(p.dim() >= 3 for p in params)


def _layer_dims(layer: nn.Module, kind: str) -> dict[str, int | None]:
    """The torch dims a layer's weight and bias shard along under ``kind``:
    col shards Flax's output axis (and the bias), row its input axis."""
    if kind == "rep":
        return {"weight": None, "bias": None}
    axes = flax_axes(layer)["weight"]
    flax_dim = len(axes) - (1 if kind == "col" else 2)
    return {"weight": axes[flax_dim], "bias": 0 if kind == "col" else None}


def tp_param_specs(model: nn.Module, n_shards: int) -> dict[str, int | None]:
    """The dim each parameter of ``model`` shards along over the model axis
    (None: replicated), by the rules of the module docstring
    (``tp_param_specs``, ``tp.py:236-252``), in the port's coordinates."""
    specs = {name: None for name, _ in model.named_parameters()}
    for expert_name, expert in model.named_children():
        if is_bank(expert, n_shards):
            for name, _ in expert.named_parameters():
                specs[f"{expert_name}.{name}"] = 0
            continue
        for layer_name, kind in expert_kinds(expert, n_shards).items():
            layer = expert.get_submodule(layer_name)
            for leaf, dim in _layer_dims(layer, kind).items():
                if getattr(layer, leaf, None) is not None:
                    specs[f"{expert_name}.{layer_name}.{leaf}"] = dim
    return specs


def plan_expert(expert: nn.Module, tp_mesh) -> TPGroup | None:
    """Ready ``expert`` to run on its model group's shards: each Dense and
    conv layer gets its ``tp_kind`` and the expert's :class:`TPGroup`
    (``tp_group``); a bank is marked by the group alone. Returns the group,
    or None without a mesh or at one rank a group (nothing changes)."""
    if tp_mesh is None or tp_mesh.model_size <= 1:
        return None
    tp = TPGroup(tp_mesh)
    for layer_name, kind in expert_kinds(expert, tp.size).items():
        layer = expert.get_submodule(layer_name)
        layer.tp_kind, layer.tp_group = kind, tp
    return tp


def tp_shard(state, mesh):
    """Place a train state of a model built with ``tp_mesh=mesh`` on the
    model group (``tp_shard``, ``tp.py:272-310``): each rank keeps its
    slice of every sharded parameter, of the EMA shadow's, of Adam's moments
    and of the running mean of gradient accumulation, by
    :func:`tp_param_specs`; the state gets the :class:`Layout` that the
    norm, the checkpoints and the eval gather read. Returns the state."""
    if not any(getattr(m, "tp_group", None) for m in state.model.modules()):
        raise ValueError("tp_shard needs a model built with tp_mesh (configs.build_model)")
    dims = tp_param_specs(state.model, mesh.model_size)
    layout = Layout(dims, mesh.model_group, mesh.model_size, mesh.model_rank, kind="tp")
    return layout.place(state)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather_dim(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.tp, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _block(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.tp.group, ctx.tp.size), None, None


def _block(x: torch.Tensor, tp: TPGroup, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).contiguous()


def copy_in(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """``x`` (replicated) into a column-parallel region: the identity, whose
    gradient is summed over the model group (each rank's part of it comes
    from its own channels)."""
    return _CopyIn.apply(x, tp)


def reduce_out(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of the model group's partial products (a row-parallel
    layer's), replicated; its gradient passes as it is."""
    return _ReduceOut.apply(x, tp)


def gather_out(x: torch.Tensor, tp: TPGroup, dim: int) -> torch.Tensor:
    """The model group's blocks of ``x`` along ``dim``, concatenated in rank
    order; the gradient of each rank's block is its slice."""
    return _GatherOut.apply(x, tp, dim)


def split(x: torch.Tensor, tp: TPGroup, dim: int) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; the gradient of
    ``x`` gathers the group's blocks."""
    return _Split.apply(x, tp, dim)
