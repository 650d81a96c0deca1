"""The two-party step: the port's entry points."""
