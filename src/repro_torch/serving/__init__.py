"""Serving runtime of the port: continuous batching over the bit-resident
LM (`engine.ServingEngine`, `scheduler.Scheduler`), with fault injection
and the typed serving errors (`faults`)."""
from repro_torch.serving.engine import Request, Scheduler, ServingEngine
from repro_torch.serving.faults import (FaultPlan, InvariantViolation,
                                        QueueFull, ReplicaDead, RequestError,
                                        ServingError, TransientDeviceError,
                                        parse_plan)

__all__ = [
    "Request", "Scheduler", "ServingEngine",
    "FaultPlan", "parse_plan", "ServingError", "RequestError", "QueueFull",
    "TransientDeviceError", "ReplicaDead", "InvariantViolation",
]
