"""``paddle_tpu.vision`` in the port: the models (``vision.models``)."""
