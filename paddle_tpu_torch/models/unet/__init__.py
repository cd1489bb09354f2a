from .modeling import (  # noqa: F401
    CrossAttnBlock,
    ResBlock,
    UNet2DConditionModel,
    UNetConfig,
    timestep_embedding,
)
