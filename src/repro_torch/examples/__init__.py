"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
the counterparts of the reference's ``examples/`` scripts, on the card
unless ``--device cpu`` is given."""
