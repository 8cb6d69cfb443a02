"""The LM launchers of the port: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (counterparts of the
reference's ``launch/train.py`` and ``launch/serve.py``)."""
