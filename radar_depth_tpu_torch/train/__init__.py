"""Train and eval steps of the port (``state.py``, ``step.py``)."""
