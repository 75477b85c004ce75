"""The port's fault-tolerant training loop."""
from repro_torch.runtime.trainer import (StragglerWatchdog, TrainLoop,
                                         TrainState)

__all__ = ["TrainLoop", "TrainState", "StragglerWatchdog"]
