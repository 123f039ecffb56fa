"""repro_torch.ft — the restartable training loop, failure injection and
straggler-tolerant gradient accumulation (``controller``)."""
from repro_torch.ft.controller import FailureInjector, TrainController, accumulate_grads

__all__ = ["FailureInjector", "TrainController", "accumulate_grads"]
