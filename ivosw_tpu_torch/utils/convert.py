"""Carry weights across: nested dicts of numpy arrays → torch state dicts.

The JAX package stores flax/optax trees (AssessNet variables, Brain params);
given those trees as numpy arrays these functions build the state dicts of
the port's modules, whose names follow the JAX trees. Layout changes only:

- Conv kernel HWIO [kh, kw, in, out] → OIHW ``weight``; conv ``bias`` as is.
- Dense kernel [in, out] → ``weight`` [out, in].
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  → ``weight``/``bias``/``running_mean``/``running_var``.
- LSTM ``w_ih``/``w_hh`` [H, 4H] → ``weight_ih``/``weight_hh`` [4H, H], gate
  order i, f, g, o unchanged.
- GroupNorm ``scale``/``bias`` → ``weight``/``bias`` (the VOS backbones).

:func:`assess_numpy_from_state_dict` and :func:`brain_numpy_from_state_dict`
are the inverses for AssessNet and the Brain, so a net trained by the port
can be held against the JAX package's trees.

The port reads no checkpoint format of the JAX package; reading those trees
into numpy is the caller's business (the tests do it with the JAX
package's own loader).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _walk(params: Dict[str, Any], stats: Dict[str, Any], prefix: str, out: StateDict):
    for name, node in params.items():
        path = prefix + name
        if "kernel" in node:
            kernel = np.asarray(node["kernel"], dtype=np.float32)
            if kernel.ndim == 4:  # conv HWIO → OIHW
                out[path + ".weight"] = _t(kernel.transpose(3, 2, 0, 1))
            elif kernel.ndim == 2:  # dense [in, out] → [out, in]
                out[path + ".weight"] = _t(kernel.T)
            else:
                raise ValueError(f"{path}: unexpected kernel shape {kernel.shape}")
            if "bias" in node:
                out[path + ".bias"] = _t(node["bias"])
        elif "scale" in node:  # BatchNorm
            out[path + ".weight"] = _t(node["scale"])
            out[path + ".bias"] = _t(node["bias"])
            out[path + ".running_mean"] = _t(stats[name]["mean"])
            out[path + ".running_var"] = _t(stats[name]["var"])
        else:
            _walk(node, stats.get(name, {}), path + ".", out)


def assess_state_dict_from_numpy(variables: Dict[str, Any]) -> StateDict:
    """AssessNet variables ({"params": ..., "batch_stats": ...} unfolded, or
    {"params": ...} folded) → state dict of ``AssessNet(fold=...)``."""
    out: StateDict = {}
    _walk(variables["params"], variables.get("batch_stats", {}), "", out)
    return out


def assess_numpy_from_state_dict(state_dict: StateDict) -> Dict[str, Any]:
    """State dict of ``AssessNet`` → {"params": ..., "batch_stats": ...}
    nested dicts of float32 numpy arrays in the JAX package's layout (the
    inverse of :func:`assess_state_dict_from_numpy`; a folded net has no
    ``batch_stats`` entries)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def node(tree, path):
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        x = np.array(value.detach().cpu().float().numpy())  # a copy, not a view
        if leaf in ("running_mean", "running_var"):
            node(stats, path)["mean" if leaf == "running_mean" else "var"] = x
        elif leaf == "weight" and x.ndim == 4:  # conv OIHW → HWIO
            node(params, path)["kernel"] = np.ascontiguousarray(x.transpose(2, 3, 1, 0))
        elif leaf == "weight" and x.ndim == 2:  # dense [out, in] → [in, out]
            node(params, path)["kernel"] = np.ascontiguousarray(x.T)
        elif leaf == "weight":  # BatchNorm
            node(params, path)["scale"] = x
        elif leaf == "bias":
            node(params, path)["bias"] = x
        else:
            raise ValueError(f"{key}: unexpected entry")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def brain_state_dict_from_numpy(params: Dict[str, Any]) -> StateDict:
    """Brain params (enc_fc1/2, lstm, dec_fc1/2) → state dict of ``Brain``."""
    out: StateDict = {}
    for name in ("enc_fc1", "enc_fc2", "dec_fc1", "dec_fc2"):
        out[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        out[f"{name}.bias"] = _t(params[name]["bias"])
    out["lstm.weight_ih"] = _t(np.asarray(params["lstm"]["w_ih"]).T)
    out["lstm.weight_hh"] = _t(np.asarray(params["lstm"]["w_hh"]).T)
    return out


def _backbone_state_dict(params: Dict[str, Any]) -> StateDict:
    """A VOS backbone's flax params (with or without a top-level
    ``"params"``) → the state dict of the port's module, whose submodules
    carry the flax tree's names: conv kernels HWIO → OIHW, GroupNorm
    ``scale`` → ``weight``, biases as they are."""
    params = params.get("params", params)
    out: StateDict = {}

    def walk(node, prefix):
        for name, child in node.items():
            path = prefix + name
            if not isinstance(child, dict):
                x = np.asarray(child, dtype=np.float32)
                if name == "kernel":
                    out[prefix + "weight"] = _t(x.transpose(3, 2, 0, 1))
                elif name == "scale":
                    out[prefix + "weight"] = _t(x)
                elif name == "bias":
                    out[prefix + "bias"] = _t(x)
                else:
                    raise ValueError(f"{path}: unexpected entry")
            else:
                walk(child, path + ".")

    walk(params, "")
    return out


def tapnet_state_dict_from_numpy(params: Dict[str, Any]) -> StateDict:
    """TAPNet params (the flax tree ``frame_encoder``/``anet``/``tnet``) →
    state dict of :class:`ivosw_tpu_torch.models.vos.tapnet.TAPNet`."""
    return _backbone_state_dict(params)


def matchnet_state_dict_from_numpy(params: Dict[str, Any]) -> StateDict:
    """MatchNet params (the flax tree ``emb_enc``/``int_head``/``prop_head``)
    → state dict of :class:`ivosw_tpu_torch.models.vos.matchnet.MatchNet`."""
    return _backbone_state_dict(params)


def ipnet_state_dict_from_numpy(params: Dict[str, Any]) -> StateDict:
    """IPNet params (the flax tree ``frame_enc``/``interaction``/
    ``propagation``) → state dict of
    :class:`ivosw_tpu_torch.models.vos.ipnet.IPNet`."""
    return _backbone_state_dict(params)


def brain_numpy_from_state_dict(state_dict: StateDict) -> Dict[str, Any]:
    """State dict of ``Brain`` → its params as nested dicts of float32 numpy
    arrays in the JAX package's layout (the inverse of
    :func:`brain_state_dict_from_numpy`)."""
    x = lambda key: np.array(state_dict[key].detach().cpu().float().numpy())
    out: Dict[str, Any] = {
        name: {"kernel": np.ascontiguousarray(x(f"{name}.weight").T), "bias": x(f"{name}.bias")}
        for name in ("enc_fc1", "enc_fc2", "dec_fc1", "dec_fc2")
    }
    out["lstm"] = {
        "w_ih": np.ascontiguousarray(x("lstm.weight_ih").T),
        "w_hh": np.ascontiguousarray(x("lstm.weight_hh").T),
    }
    return out
