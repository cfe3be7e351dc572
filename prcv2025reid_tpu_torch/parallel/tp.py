"""Tensor parallelism: Megatron column and row shards over the model axis of
a 2-D ``('data', 'model')`` mesh (counterpart of the JAX package's
``parallel/tp.py``, with its rules and names).

JAX's rules, per leaf (:func:`leaf_partition_spec`):

- ``q_proj``, ``k_proj``, ``v_proj`` and ``fc1`` are column-parallel: the
  kernel ``[in, out]`` is sharded on its output dim, as are the bias and
  ``lora_B`` ``[experts, r, out]``;
- ``out_proj`` and ``fc2`` are row-parallel: the kernel is sharded on its
  input dim, as is ``lora_A`` ``[experts, in, r]``; the bias and ``lora_B``
  stay replicated;
- everything else is replicated, and so is a leaf whose dim the model size
  does not divide.

JAX places the parameters and GSPMD inserts the collectives.  The port's
kernels take whole local weights, so the blocks make the collectives
themselves (``parallel/collectives.py``): a column section starts with
``copy_to_model`` and computes this process's outputs (``q_proj``'s output
is head-major, so a shard is ``H/m`` whole heads and the attention core runs
on them); a row product's partial sums go through ``reduce_from_model``,
and its replicated bias is added once after.  :func:`shard_variables` slices
every sharded leaf to this process's model index in place and tells each
section its mesh.

Where the port keeps JAX-sharded leaves replicated (placement never changes
the numbers, ROADMAP.md §3):

- an attention layer whose head count the model size does not divide (JAX
  may split a head; the port's local-heads core cannot): its four
  projections;
- the fusion's ``q/k/v/out_proj`` and the SDM module's ``v_proj``, which
  JAX's rules shard by name: they act on a handful of tokens a sample, and
  the SDM's ``attn_out_proj`` is replicated, so its input would need a
  gather.

Gradients: a replicated leaf inside a section gets a partial gradient on
each process (a column layer's ``lora_A`` feeds this process's ``lora_B``
shard; a row layer's ``lora_B`` multiplies this process's ``x_l @ A_l``);
:func:`partial_grads` names them, and the train step sums exactly those over
the model group, once.  Every other replicated leaf has its whole gradient
on every process of the group.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from prcv2025reid_tpu_torch.models.mer import MERAttention, MERDense, MERMlp
from prcv2025reid_tpu_torch.models.text import TextBlock
from prcv2025reid_tpu_torch.parallel.collectives import model_all_gather
from prcv2025reid_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, model_spanning

# column-parallel (output dim sharded) / row-parallel (input dim sharded)
_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")

Spec = Tuple[Optional[str], ...]


def leaf_partition_spec(path_keys: Sequence[str], shape: Sequence[int],
                        model_size: int) -> Spec:
    """JAX's PartitionSpec of one parameter or optimizer leaf, as a tuple
    (``()``: replicated; ``(None, 'model')``: dim 1 sharded).  The
    projection name among ``path_keys`` and the leaf name decide it; a leaf
    whose sharded dim ``model_size`` does not divide is replicated."""
    keys = set(path_keys)
    leaf = path_keys[-1] if path_keys else ""
    col = any(k in keys for k in _COLUMN)
    row = any(k in keys for k in _ROW)
    if not (col or row) or (col and row):
        return ()

    def ok(dim: int) -> bool:
        return 0 <= dim < len(shape) and shape[dim] % model_size == 0 and shape[dim] >= model_size

    if col:
        if leaf == "kernel" and len(shape) == 2 and ok(1):
            return (None, MODEL_AXIS)  # [in, out]
        if leaf == "bias" and len(shape) == 1 and ok(0):
            return (MODEL_AXIS,)
        if leaf == "lora_B" and len(shape) == 3 and ok(2):
            return (None, None, MODEL_AXIS)  # [experts, r, out]
        return ()
    if leaf == "kernel" and len(shape) == 2 and ok(0):
        return (MODEL_AXIS, None)  # [in, out]
    if leaf == "lora_A" and len(shape) == 3 and ok(1):
        return (None, MODEL_AXIS, None)  # [experts, in, r]
    return ()


def path_keys(name: str) -> Tuple[str, ...]:
    """A state-dict name (``a.b.c``) or a flat flax key (``params/a/b/c``)
    as its path components."""
    return tuple(name.replace("/", ".").split("."))


def tree_partition_specs(tree: Mapping[str, object], model_size: int) -> Dict[str, Spec]:
    """{name: spec} over a state dict, or a flat ``/``-keyed dict, of
    parameters (their names map one-to-one onto the flax paths)."""
    return {k: leaf_partition_spec(path_keys(k), tuple(getattr(v, "shape", ())), model_size)
            for k, v in tree.items()}


def _sharded_dim(spec: Spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


_ATTN = (("q_proj", "column"), ("k_proj", "column"), ("v_proj", "column"), ("out_proj", "row"))
_MLP = (("fc1", "column"), ("fc2", "row"))


def _sections(unit):
    """(projections and roles, the attribute that holds the mesh, heads) of
    each section of a unit the port shards: the vision blocks' attention
    and MLP, and the text blocks' two (the fusion and the SDM module stay
    replicated, see the module docstring); None for another module."""
    if isinstance(unit, MERAttention):
        return [(_ATTN, "tp", unit.num_heads)]
    if isinstance(unit, MERMlp):
        return [(_MLP, "tp", None)]
    if isinstance(unit, TextBlock):
        return [(_ATTN, "tp_attn", unit.num_heads), (_MLP, "tp_mlp", None)]
    return None


def _plan_section(prefix: str, layers, model_size: int, heads: Optional[int]
                  ) -> Optional[Dict[str, int]]:
    """{parameter name: sharded dim} of one section (attention or MLP), or
    None where the port keeps it replicated: JAX's rules shard none of its
    kernels, split one unevenly, or split a head."""
    plan: Dict[str, int] = {}
    for attr, layer, _ in layers:
        for pname, p in layer.named_parameters():
            name = f"{prefix}{attr}.{pname}"
            dim = _sharded_dim(leaf_partition_spec(path_keys(name), tuple(p.shape), model_size))
            if dim is not None:
                plan[name] = dim
    kernels = [f"{prefix}{attr}.{'shared.' if isinstance(layer, MERDense) else ''}kernel"
               for attr, layer, _ in layers]
    if not all(k in plan for k in kernels):
        return None
    if heads is not None and heads % model_size:
        return None
    return plan


def shard_variables(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Slice every sharded parameter of ``model`` to this process's model
    index, in place, and tell each section its mesh (a mesh without a model
    axis: nothing changes).  Records the plan on the model: ``tp_mesh``,
    ``tp_plan`` ({parameter name: sharded dim}) and ``tp_partial`` (the
    replicated leaves whose gradients are partial sums).  Returns the model."""
    mp = model_spanning(mesh)
    if mp is None or getattr(model, "tp_mesh", None) is not None:
        return model
    m, j = mp.model_size, mp.model_rank
    plan: Dict[str, int] = {}
    partial: List[str] = []
    for uname, unit in model.named_modules():
        prefix = f"{uname}."
        for projs, attr, heads in _sections(unit) or ():
            layers = [(n, getattr(unit, n), role) for n, role in projs]
            sec = _plan_section(prefix, layers, m, heads)
            if sec is None:
                continue
            plan.update(sec)
            setattr(unit, attr, mp)
            for pname, layer, role in layers:
                if role == "row":
                    layer.tp_row = mp
                    if isinstance(layer, MERDense):
                        layer.shared.tp_row = mp
                        partial.append(f"{prefix}{pname}.lora_B")
                elif isinstance(layer, MERDense):
                    layer.tp_col = mp
                    partial.append(f"{prefix}{pname}.lora_A")
    with torch.no_grad():
        for name, dim in plan.items():
            p = model.get_parameter(name)
            p.data = _local(p.data, dim, m, j)
    model.tp_mesh, model.tp_plan, model.tp_partial = mp, plan, frozenset(partial)
    return model


def _local(t: torch.Tensor, dim: int, m: int, j: int) -> torch.Tensor:
    n = t.shape[dim] // m
    return t.narrow(dim, j * n, n).clone()


def shard_state(model: torch.nn.Module, state, mesh: Optional[Mesh]):
    """:func:`shard_variables`, and each sharded trainable parameter's
    optimizer moments (and accumulation buffer) sliced alike, as JAX's
    ``shard_state`` places a whole ``TrainState``.  Returns the state."""
    if model_spanning(mesh) is None or getattr(model, "tp_mesh", None) is not None:
        return state
    shard_variables(model, mesh)
    opt = state.opt_state
    return state.replace(opt_state=opt.replace(
        mu=local_list(model, opt.mu), nu=local_list(model, opt.nu),
        acc=local_list(model, opt.acc) if opt.acc else []))


def trainable_names(model: torch.nn.Module) -> List[str]:
    """The trainable parameters' names in the optimizer state's order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def is_sharded(model: torch.nn.Module) -> bool:
    return getattr(model, "tp_mesh", None) is not None


def local_shard(model: torch.nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This process's shard of a whole leaf ``name`` (the leaf itself where
    the model holds it whole)."""
    plan = getattr(model, "tp_plan", {})
    if name not in plan:
        return full
    mp = model.tp_mesh
    return _local(full, plan[name], mp.model_size, mp.model_rank)


def local_list(model: torch.nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-trainable-parameter tensors (moments) of whole shapes -> shards."""
    return [local_shard(model, n, t) for n, t in zip(trainable_names(model), tensors)]


def full_leaf(model: torch.nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole leaf ``name`` from this process's shard ``t``, on every
    process of the model group (a collective there)."""
    plan = getattr(model, "tp_plan", {})
    if name not in plan:
        return t
    return model_all_gather(t.detach(), plan[name], model.tp_mesh)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded leaf whole (a collective
    over the model group)."""
    return {k: full_leaf(model, k, v) for k, v in model.state_dict().items()}


def full_list(model: torch.nn.Module, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-trainable-parameter shards -> whole tensors (a collective)."""
    return [full_leaf(model, n, t) for n, t in zip(trainable_names(model), tensors)]


def partial_grads(model: torch.nn.Module, names: Sequence[str]) -> List[bool]:
    """For each parameter name: whether its gradient is a partial sum over
    the model group (see the module docstring)."""
    partial = getattr(model, "tp_partial", frozenset())
    return [n in partial for n in names]


def sharded_leaves(model: torch.nn.Module, names: Sequence[str]) -> List[bool]:
    """For each parameter name: whether this process holds a shard of it."""
    plan = getattr(model, "tp_plan", {})
    return [n in plan for n in names]
