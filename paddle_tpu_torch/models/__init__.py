"""Models of the port: ``gpt`` and ``gpt_hybrid`` are the counterparts
of ``paddle_tpu/models/gpt.py`` and ``gpt_hybrid.py``, ``bert`` of
``paddle_tpu/models/bert.py`` (at ``mesh=None``), and ``common`` holds
their shared tree walk, train-step update and ``PytreeLayer``."""
