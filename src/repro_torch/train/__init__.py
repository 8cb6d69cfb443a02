"""Training of the dense family: AdamW, the train step, the data
pipeline, checkpoints and the recoverable loop (counterpart of the
reference's ``train/``)."""
