"""Device resolution shared by the port's entry points.

Entry points take ``device=None`` and run on ``"cuda"``; ``"cpu"`` must
be asked for.  There is no silent fallback: asking for CUDA where
``torch.cuda.is_available()`` is False raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# float32 min, the same sentinel as the reference's scoring.NEG_INF.  Not
# -inf: RSCH tests ``scores > NEG_INF`` and adds extra terms only there.
NEG_INF = float(torch.finfo(torch.float32).min)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when CUDA is asked
    for and no CUDA device is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev
