"""Developer tooling that ships with the repo but never imports at runtime.

Nothing under ``ray_tpu_torch.devtools`` may be imported by production
modules — it exists for ``ray_tpu_torch/scripts/lint.py``, CI gates, and
future codemod tooling.
"""
