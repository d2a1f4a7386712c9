"""The repo's runnable programs on the port (counterpart: ``examples/``):
each module runs as ``python -m ray_tpu_torch.examples.<name> [--smoke]``
and keeps the reference's ``main(smoke=...)`` return value; those that
compute take ``device`` (the card unless ``"cpu"`` is given). README.md
lists them."""
