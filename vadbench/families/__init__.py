"""The model's count of operations by family, one module per
configuration's `family` (`<family>.py`), each `flops_per_chunk(config)`:
the whole model on one chunk of the configuration. `counts` finds the
module by the family's name, so a new family comes as a file of its own."""
