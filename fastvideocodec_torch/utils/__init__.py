"""Host utilities of the port."""

from fastvideocodec_torch.utils.logs import read_eval_log, write_eval_log
from fastvideocodec_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter", "read_eval_log", "write_eval_log"]
