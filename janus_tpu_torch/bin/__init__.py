"""The process entry points (reference aggregator/src/bin/):
`python -m janus_tpu_torch.bin.aggregator` etc."""
