"""Incubating APIs of the port (``paddle_tpu.incubate``): the MoE layer,
the fused functionals (``incubate.nn.functional``) and ASP
(``incubate.asp``)."""

from . import asp, distributed, nn  # noqa: F401
