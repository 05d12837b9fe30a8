"""Device mesh for data and sequence parallelism, driven from one process.

Counterpart of ``ivosw_tpu/parallel/mesh.py``. The JAX package runs one
controller over all devices of a ``jax.sharding.Mesh``; so does the port:
one Python process places blocks of work on each device of a
:class:`Mesh` and gathers the results, with no ``torch.distributed`` (the
JAX package has no multi-process path either). CUDA launches are
asynchronous, so a loop over the devices keeps them all busy.

- :class:`Mesh`: ``axis_names`` and an array of ``torch.device``; its
  ``shape[axis]`` is the axis' size, as in JAX. Its one departure from
  ``jax.sharding.Mesh``: a device may appear more than once, so ``[cpu]*8``
  stands in for the JAX tests' eight virtual CPU devices and
  ``[cuda:0]*2`` runs a two-way mesh on one card.
- :func:`make_mesh`: the JAX package's shape rule (a 2-D mesh gives its
  model axis the largest of 4, 2, 1 dividing n); all CUDA devices unless
  ``devices`` is given.
- :func:`shard_batch`: each leading axis in contiguous blocks, one per
  device along the axis (JAX's ``P(axis)``); :func:`replicate`: a module
  or state dict on every device of the mesh.
- :func:`assess_param_shardings` / :func:`apply_shardings`: AssessNet's
  tensor-parallel rule on the port's layout: a weight's output channels
  (dim 0 of ``[out, in, kh, kw]`` and ``[out, in]``) and a 1-D tensor
  split over the model axis when divisible, else replicated.
- :func:`frame_sharded_score_clip`: sequence parallelism of the wild
  round's scoring: T padded to a multiple of the axis, each device's slab
  scored by its replica of the net (the fused-box kernel launches on that
  device), the [T, O] scores gathered on the mesh's first device.
- Data parallelism is ``train_vos.vos_train_step_dp`` over
  :func:`replicate`'s nets and :func:`shard_batch`'s blocks.
"""

from __future__ import annotations

import copy
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Devices laid out over named axes (a device may repeat)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis)."""
        k = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, k, 0).reshape(self.shape[axis], -1)[:, 0])

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; raises without
    one). A 1-D mesh takes all of them; a 2-D one favours the data axis and
    gives the model axis the largest of 4, 2, 1 that divides n."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device for the mesh; pass devices=[...]")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            model = next(c for c in (4, 2, 1) if n % c == 0)
            shape = (n // model, model)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    count = int(np.prod(shape))
    if count > n:
        raise ValueError(f"mesh shape {shape} needs {count} devices, got {n}")
    grid = np.empty(count, dtype=object)
    grid[:] = devices[:count]
    return Mesh(grid.reshape(shape), axis_names)


# ----------------------------------------------------------- placement --
def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """Split every array's leading axis into contiguous blocks, one per
    device along ``axis`` → one tree of tensors per device, each on its
    device. Host arrays are converted; the leading axis must divide."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    tree = _map(tree, torch.as_tensor)
    for x in _leaves(tree):
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f"leading axis of {tuple(x.shape)} does not split over {n} devices")
    return [
        _map(tree, lambda x, i=i, d=d: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)].to(d))
        for i, d in enumerate(devices)
    ]


def replicate(mesh: Mesh, obj) -> list:
    """``obj`` (a module or a tree of tensors) on every device of the mesh,
    in its flat order: a module lying on the first device is itself the
    first replica, every other entry is a copy (distinct even where a
    device repeats, so each can hold its own gradients)."""
    out = []
    for i, d in enumerate(mesh.devices.flat):
        if isinstance(obj, torch.nn.Module):
            param = next(obj.parameters(), None)
            same = param is not None and param.device == d
            out.append(obj if i == 0 and same else copy.deepcopy(obj).to(d))
        else:
            out.append(_map(obj, lambda x, d=d: torch.as_tensor(x).to(d, copy=True)))
    return out


def assess_param_shardings(mesh: Mesh, state_dict, model_axis: str = "model") -> dict:
    """Tensor-parallel rule for AssessNet's state dict → {name: spec}, a
    spec being JAX's ``PartitionSpec`` as a tuple: ``(model_axis, None,
    …)`` to split dim 0 (output channels of conv ``[out, in, kh, kw]`` and
    dense ``[out, in]`` weights, and 1-D biases, scales and statistics)
    when it divides by the axis' size, else ``()`` (replicated)."""
    m = mesh.shape[model_axis]
    return {
        name: ((model_axis,) + (None,) * (t.dim() - 1)) if t.dim() >= 1 and t.shape[0] % m == 0
        else ()
        for name, t in state_dict.items()
    }


def apply_shardings(mesh: Mesh, state_dict, shardings, model_axis: str = "model") -> list:
    """The state dict placed by ``shardings`` → one state dict per position
    along the model axis, on that position's device: dim 0 of a split
    tensor in contiguous blocks, a replicated one whole."""
    devices = mesh.axis_devices(model_axis)
    m = len(devices)
    out = []
    for j, d in enumerate(devices):
        part = {}
        for name, t in state_dict.items():
            if shardings[name]:
                size = t.shape[0] // m
                t = t[j * size:(j + 1) * size]
            part[name] = t.to(d, copy=True)
        out.append(part)
    return out


# ------------------------------------------------- sequence parallelism --
_replicas: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = weakref.WeakKeyDictionary()
_replicas_lock = threading.Lock()


def _version(module: torch.nn.Module) -> int:
    """Sum of the in-place version counters of the module's tensors: it
    moves whenever a parameter or buffer is written (a step, a load)."""
    return sum(t._version for t in module.state_dict().values())


def replica_on(module: torch.nn.Module, device) -> torch.nn.Module:
    """A read-only replica of ``module`` on ``device``: the module itself on
    its own device, else a cached copy, made again once the module's
    tensors have been written since (the JAX package caches its sharded
    scoring function per mesh)."""
    device = torch.device(device)
    if next(module.parameters()).device == device:
        return module
    with _replicas_lock:
        per_device = _replicas.setdefault(module, {})
        version = _version(module)
        entry = per_device.get(str(device))
        if entry is None or entry[0] != version:
            entry = per_device[str(device)] = (version, copy.deepcopy(module).to(device))
        return entry[1]


def frame_sharded_score_clip(
    mesh: Mesh,
    assess_net,
    frames: torch.Tensor,
    probs: torch.Tensor,
    obj_valid: torch.Tensor,
    obj_offset: int = 0,
    axis: str = "data",
    impl: str = "auto",
) -> torch.Tensor:
    """:func:`ivosw_tpu_torch.models.assess.score_clip` with the clip's frame
    axis split over ``axis``: T zero-padded to a multiple of the axis'
    size, device i scores the i-th slab with its replica of the net (the
    crop kernel launching there), and the [T, O] float32 scores are
    gathered on the mesh's first device, the pad dropped. Folded and
    unfolded nets alike; scores equal the one-device pass within the bf16
    noise of another batch size."""
    from ivosw_tpu_torch.models.assess import score_clip

    devices = mesh.axis_devices(axis)
    n = len(devices)
    t = frames.shape[0]
    pad = (-t) % n
    if pad:
        frames = torch.cat([frames, frames.new_zeros((pad,) + frames.shape[1:])])
        probs = torch.cat([probs, probs.new_zeros((pad,) + probs.shape[1:])])
    slab = (t + pad) // n
    scores = []
    for i, d in enumerate(devices):
        part = slice(i * slab, (i + 1) * slab)
        scores.append(score_clip(
            replica_on(assess_net, d), frames[part].to(d), probs[part].to(d),
            obj_valid.to(d), obj_offset=obj_offset, impl=impl,
        ))
    return torch.cat([s.to(devices[0]) for s in scores])[:t]
