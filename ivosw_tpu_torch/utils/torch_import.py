"""Reference and torchvision weights → the port's state dicts.

Counterpart of ``ivosw_tpu/utils/torch_import.py``. The reference
distributes ``agent.pt`` and ``assess_net.pt`` as torch state dicts in its
own module layout, and its QA training starts from torchvision's ImageNet
``resnet50``. These functions rename their keys onto the port's modules
(``models/brain.py``, ``models/assess.py``, ``models/resnet.py``); the
tensors keep their layouts, since both sides are torch. A ``module.``
prefix (``DataParallel``) is stripped.

- Brain: ``encoder_fc1/2`` → ``enc_fc1/2``, ``lstm_cell.weight_ih/hh`` →
  ``lstm.weight_ih/hh`` (the LSTM cell's biases are dropped, as the JAX
  package's converter takes only the two weights: the Brain's cell has
  none), ``decoder_fc1/2`` → ``dec_fc1/2``.
- AssessNet: ``Encoder.conv1``, ``conv1_p``, ``bn1``, ``res{2..5}.{i}.*``
  and ``fc1`` onto the unfolded net; a block's ``downsample.0/1`` becomes
  ``downsample_conv``/``downsample_bn``. The dead ``conv1_m``/``conv1_n``
  stems, the mean/std buffers and BatchNorm's ``num_batches_tracked`` are
  ignored.
- torchvision ``resnet50``: ``conv1``, ``bn1`` and ``layer{1..4}`` onto the
  stem and ``res{2..5}``; ``conv1_p`` is zero, so the fused stem starts as
  the pretrained RGB stem; ``fc1`` is the port's seeded init
  (:func:`ivosw_tpu_torch.models.assess.init_assess_net`); the 1000-class
  ``fc`` is ignored.

The loaders read a file with ``torch.load(weights_only=True)`` and return
the port's layout whether the file holds it or the reference's; a file in
neither raises, naming its unexpected keys (the JAX package's loaders
return ``None`` there and its callers score with seeded weights).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

StateDict = Dict[str, torch.Tensor]

RESNET50_STAGE_BLOCKS = {2: 3, 3: 4, 4: 6, 5: 3}
_BN = ("weight", "bias", "running_mean", "running_var")


def _strip_module(state_dict: StateDict) -> StateDict:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone()


def _copy(out: StateDict, sd: StateDict, dst: str, src: str, names) -> None:
    for n in names:
        out[f"{dst}.{n}"] = _f32(sd[f"{src}.{n}"])


def brain_state_dict_from_reference(state_dict: StateDict) -> StateDict:
    """The reference Brain's state dict → :class:`~ivosw_tpu_torch.models.brain.Brain`'s."""
    sd = _strip_module(state_dict)
    out: StateDict = {}
    for dst, src in (("enc_fc1", "encoder_fc1"), ("enc_fc2", "encoder_fc2"),
                     ("dec_fc1", "decoder_fc1"), ("dec_fc2", "decoder_fc2")):
        _copy(out, sd, dst, src, ("weight", "bias"))
    _copy(out, sd, "lstm", "lstm_cell", ("weight_ih", "weight_hh"))
    return out


def _trunk(sd: StateDict, prefix_for_block: Callable[[int, int], str]) -> StateDict:
    """ResNet-50 bottlenecks res2..res5; ``prefix_for_block(stage, i)`` is
    the key prefix of block i of a stage in the source."""
    out: StateDict = {}
    for stage, n_blocks in RESNET50_STAGE_BLOCKS.items():
        for i in range(n_blocks):
            src, dst = prefix_for_block(stage, i), f"trunk.res{stage}.block{i}"
            for j in (1, 2, 3):
                _copy(out, sd, f"{dst}.conv{j}", f"{src}conv{j}", ("weight",))
                _copy(out, sd, f"{dst}.bn{j}", f"{src}bn{j}", _BN)
            if f"{src}downsample.0.weight" in sd:
                _copy(out, sd, f"{dst}.downsample_conv", f"{src}downsample.0", ("weight",))
                _copy(out, sd, f"{dst}.downsample_bn", f"{src}downsample.1", _BN)
    return out


def assess_state_dict_from_reference(
    state_dict: StateDict, encoder_prefix: str = "Encoder."
) -> StateDict:
    """The reference AssessNet's state dict → the unfolded
    :class:`~ivosw_tpu_torch.models.assess.AssessNet`'s."""
    sd = _strip_module(state_dict)
    e = encoder_prefix
    out: StateDict = {}
    _copy(out, sd, "conv1", e + "conv1", ("weight",))
    _copy(out, sd, "conv1_p", e + "conv1_p", ("weight",))
    _copy(out, sd, "bn1", e + "bn1", _BN)
    out.update(_trunk(sd, lambda stage, i: f"{e}res{stage}.{i}."))
    _copy(out, sd, "fc1", "fc1", ("weight", "bias"))
    return out


def assess_state_dict_from_torchvision_resnet50(state_dict: StateDict, seed: int = 0) -> StateDict:
    """An unfolded AssessNet state dict with a torchvision ``resnet50``'s
    stem and trunk, ``conv1_p`` zero and the seeded ``fc1``."""
    from ivosw_tpu_torch.models.assess import init_assess_net

    sd = _strip_module(state_dict)
    out = {k: v.clone() for k, v in init_assess_net(seed).state_dict().items()}
    _copy(out, sd, "conv1", "conv1", ("weight",))
    out["conv1_p.weight"] = torch.zeros_like(out["conv1_p.weight"])
    _copy(out, sd, "bn1", "bn1", _BN)
    out.update(_trunk(sd, lambda stage, i: f"layer{stage - 1}.{i}."))
    return out


# ---------------------------------------------------------------- layouts --
def _port_keys(kind: str):
    if kind == "brain":
        from ivosw_tpu_torch.models.brain import Brain

        return set(Brain().state_dict())
    from ivosw_tpu_torch.models.assess import AssessNet

    with torch.device("meta"):
        return set(AssessNet().state_dict())


def _to_port_layout(state_dict: StateDict, kind: str, marker: str, convert, source: str):
    """``state_dict`` in the port's layout as is; in the reference's
    (recognised by ``marker``) converted; in neither, raise naming the
    keys the port's layout does not have."""
    sd = _strip_module(state_dict)
    expected = _port_keys(kind)
    if set(sd) == expected:
        return sd
    if marker in sd:
        return convert(sd)
    unexpected = sorted(set(sd) - expected)
    missing = sorted(expected - set(sd))
    raise RuntimeError(
        f"{source or kind}: a state_dict in neither the port's {kind} layout nor the "
        f"reference's; unexpected keys {unexpected[:12]}"
        f"{' …' if len(unexpected) > 12 else ''} ({len(unexpected)}), "
        f"{len(missing)} of the port's keys missing"
    )


def brain_state_dict(state_dict: StateDict, source: str = "") -> StateDict:
    """A Brain state dict in the port's layout or the reference's → the port's."""
    return _to_port_layout(state_dict, "brain", "encoder_fc1.weight",
                           brain_state_dict_from_reference, source)


def assess_state_dict(state_dict: StateDict, source: str = "") -> StateDict:
    """An unfolded AssessNet state dict in the port's layout or the
    reference's → the port's."""
    return _to_port_layout(state_dict, "AssessNet", "Encoder.conv1.weight",
                           assess_state_dict_from_reference, source)


def _load(path: str) -> Optional[StateDict]:
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def load_agent_checkpoint_pt(path: str) -> Optional[StateDict]:
    """``agent.pt`` (the port's Brain or the reference's) → the port's
    Brain state dict; None when the file does not exist."""
    sd = _load(path)
    return None if sd is None else brain_state_dict(sd, path)


def load_assess_checkpoint_pt(path: str) -> Optional[StateDict]:
    """``assess_net.pt`` (the port's unfolded AssessNet or the reference's)
    → the port's state dict; None when the file does not exist."""
    sd = _load(path)
    return None if sd is None else assess_state_dict(sd, path)


def init_assess_from_imagenet(path: str, seed: int = 0):
    """An unfolded AssessNet (CPU, float32 parameters, eval mode) whose stem
    and trunk come from the torchvision ``resnet50`` state dict in
    ``path``. A missing or unreadable file raises ``FileNotFoundError``; a
    readable one without the ResNet-50 keys raises ``RuntimeError`` naming
    the keys it lacks."""
    from ivosw_tpu_torch.models.assess import AssessNet

    message = f"assess_net.imagenet_ckpt={path!r} is not a readable torchvision resnet50 state_dict"
    try:
        sd = _load(path)
    except Exception as exc:
        raise FileNotFoundError(message) from exc
    if sd is None:
        raise FileNotFoundError(message)
    try:
        state = assess_state_dict_from_torchvision_resnet50(sd, seed)
    except KeyError as exc:
        raise RuntimeError(
            f"{path}: not a torchvision resnet50 state_dict: no key {exc}; its keys "
            f"{sorted(sd)[:12]}{' …' if len(sd) > 12 else ''}"
        ) from exc
    net = AssessNet()
    net.load_state_dict(state)
    return net.eval()
