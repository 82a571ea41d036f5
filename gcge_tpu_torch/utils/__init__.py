"""Utilities of the port: the ``-gcge_*`` command line (:mod:`.cli`),
checkpoints (:mod:`.checkpoint`), memory accounting (:mod:`.meminfo`) and
host conversions (:mod:`.convert`)."""

from gcge_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gcge_tpu_torch.utils.cli import params_from_args, print_usage

__all__ = ["params_from_args", "print_usage", "save_checkpoint",
           "load_checkpoint"]
