"""Backbone factory: config name → adapter instance (``cfg.vos``)."""

from __future__ import annotations

import torch

from ivosw_tpu_torch.core.config import Config


def build_backbone(cfg: Config, registry, device=None):
    """``fake`` (host-side), or ``tapnet``, ``matchnet`` or ``ipnet`` on
    ``device`` (None: CUDA; raises without a GPU), with the weights of
    ``cfg.ckpt_dir`` when present, else seeded by ``cfg.seed``. The
    adapters' prob maps are stored in bfloat16 when
    ``cfg.assess_net.bf16_inputs`` is set; masks are computed before the
    cast and do not move."""
    name = cfg.vos
    if name == "fake":
        from ivosw_tpu_torch.models.vos.fake import FakeVOS

        return FakeVOS(registry)
    if name == "tapnet":
        from ivosw_tpu_torch.models.vos.tapnet import TAPNetAdapter as adapter
    elif name == "matchnet":
        from ivosw_tpu_torch.models.vos.matchnet import MatchNetAdapter as adapter
    elif name == "ipnet":
        from ivosw_tpu_torch.models.vos.ipnet import IPNetAdapter as adapter
    else:
        raise NotImplementedError(f"unknown VOS backbone: {name}")
    qa_dtype = (
        torch.bfloat16 if getattr(cfg.assess_net, "bf16_inputs", False) else torch.float32
    )
    return adapter.create(seed=cfg.seed, ckpt_dir=cfg.ckpt_dir, qa_dtype=qa_dtype,
                          device=device)
