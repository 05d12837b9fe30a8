from ivosw_tpu_torch.models.vos.protocol import VOSAdapter, SegmentationResult

__all__ = ["VOSAdapter", "SegmentationResult"]
