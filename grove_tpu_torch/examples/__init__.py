"""The workload-archetype examples and the operations tour on the port:
`python -m grove_tpu_torch.examples.<name> [--device cpu]`."""
