"""AdamW with a cosine schedule (twin of ``repro/optim``)."""
