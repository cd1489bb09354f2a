"""Neural-network functionals of the port (``paddle_tpu.nn``): the attention
surface in ``nn.functional``."""
