"""Serving for the port (the legacy continuous-batching engine in this
slice)."""

from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      Request, RequestShed)
