"""Serving runtime of the port: continuous batching over the bit-resident
LM (`engine.ServingEngine`, `scheduler.Scheduler`)."""
