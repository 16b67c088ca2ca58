"""Fault-tolerant training loop, step factory and straggler detection
(port of ``src/repro/train``)."""
from repro_torch.train.loop import Trainer, make_train_step, value_and_grad
from repro_torch.train.straggler import StragglerEvent, StragglerMonitor

__all__ = ["StragglerEvent", "StragglerMonitor", "Trainer",
           "make_train_step", "value_and_grad"]
