"""Device barrier of the port for timing code.

Counterpart of ts_asr_whisper_tpu/utils/device.py: PyTorch queues CUDA work
and returns before it runs, so a host clock needs a barrier after the work.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves


def force_execution(tree) -> None:
    """Wait until every kernel queued on the CUDA device of the first tensor
    in ``tree`` has finished (``torch.cuda.synchronize``). Tensors on the CPU
    are ready when returned: nothing to wait for."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return
