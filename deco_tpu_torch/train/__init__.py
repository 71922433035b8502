"""Training state, schedules and the train step (``deco_tpu/train``)."""
