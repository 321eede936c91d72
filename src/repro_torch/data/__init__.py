"""The synthetic, seeded token pipeline (``pipeline.py``)."""
