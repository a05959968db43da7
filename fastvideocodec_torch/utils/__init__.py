"""Host utilities of the port."""

from fastvideocodec_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter"]
