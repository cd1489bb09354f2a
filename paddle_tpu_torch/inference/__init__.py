"""Serving for the port: the continuous-batching engine with its prefix
cache and fused mega-step."""

from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      PrefixCacheConfig, Request, RequestShed)
