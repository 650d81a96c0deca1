"""The port's aggregator: the EngineCache seam, the helper's aggregate-init
and aggregate-share and its HTTP server, the leader's job creator, job
driver and collection job driver, and the garbage collector."""
