"""Incubating APIs of the port (``paddle_tpu.incubate``): the MoE layer and
the fused serving and MoE functionals (``incubate.nn.functional``)."""
