"""Backbone factory: config name → adapter instance (``cfg.vos``)."""

from __future__ import annotations

import torch

from ivosw_tpu_torch.core.config import Config

_LATER = {
    "matchnet": "the matchnet/ipnet slice",
    "ipnet": "the matchnet/ipnet slice",
}


def build_backbone(cfg: Config, registry, device=None):
    """``fake`` (host-side) or ``tapnet`` on ``device`` (None: CUDA). The
    adapters' prob maps are stored in bfloat16 when
    ``cfg.assess_net.bf16_inputs`` is set; masks are computed before the
    cast and do not move."""
    name = cfg.vos
    if name == "fake":
        from ivosw_tpu_torch.models.vos.fake import FakeVOS

        return FakeVOS(registry)
    qa_dtype = (
        torch.bfloat16 if getattr(cfg.assess_net, "bf16_inputs", False) else torch.float32
    )
    if name == "tapnet":
        from ivosw_tpu_torch.models.vos.tapnet import TAPNetAdapter

        return TAPNetAdapter.create(
            seed=cfg.seed, ckpt_dir=cfg.ckpt_dir, qa_dtype=qa_dtype, device=device
        )
    if name in _LATER:
        raise NotImplementedError(
            f"VOS backbone {name!r} is not ported yet ({_LATER[name]}); use vos=fake or tapnet"
        )
    raise NotImplementedError(f"unknown VOS backbone: {name}")
