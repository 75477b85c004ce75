"""TrainSession: the port's front door for training."""
from repro_torch.session.session import SessionResult, TrainSession

__all__ = ["SessionResult", "TrainSession"]
