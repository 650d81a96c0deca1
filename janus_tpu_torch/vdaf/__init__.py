"""Prio3 on the device: circuits, XOF, FLP engine, batched Prio3, registry."""
