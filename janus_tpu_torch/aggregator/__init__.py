"""The port's aggregator: the EngineCache seam, the helper's aggregate-init
and its HTTP server, and the leader's job creator and job driver."""
