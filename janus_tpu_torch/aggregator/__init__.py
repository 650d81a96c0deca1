"""The port's aggregator: the EngineCache seam and the helper's aggregate-init."""
