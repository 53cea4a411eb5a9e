"""Device selection for the port's entry points, and the one lock that
the engines' work on a device holds."""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.utils.locks import InstrumentedLock

#: held around every plan search (:meth:`CudaGoalOptimizer.optimize`) and
#: every what-if batch (:func:`whatif.engine.evaluate_batch`), whatever
#: thread asks: the process runs one of them at a time, as the reference's
#: TPU ran one program at a time.  On the card this keeps another thread's
#: synchronizing call out of a CUDA-graph capture, which the step loop
#: makes in the global capture mode
DEVICE_LOCK = InstrumentedLock("device")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and no card is present (never a silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    return dev
