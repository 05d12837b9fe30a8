"""Backbone factory: config name → adapter instance (``cfg.vos``)."""

from __future__ import annotations

from ivosw_tpu_torch.core.config import Config

_LATER = {
    "tapnet": "the TAPNet slice",
    "matchnet": "the matchnet/ipnet slice",
    "ipnet": "the matchnet/ipnet slice",
}


def build_backbone(cfg: Config, registry):
    name = cfg.vos
    if name == "fake":
        from ivosw_tpu_torch.models.vos.fake import FakeVOS

        return FakeVOS(registry)
    if name in _LATER:
        raise NotImplementedError(
            f"VOS backbone {name!r} is not ported yet ({_LATER[name]}); use vos=fake"
        )
    raise NotImplementedError(f"unknown VOS backbone: {name}")
