"""repro_torch.serving — the elastic decode serving plane.

A pool of decode workers managed by the
:class:`~repro_torch.core.engine.ReconfigEngine`, grown and shrunk by
traffic-driven RMS policies, with in-flight KV caches migrated (never
dropped) and priced as REDISTRIBUTION bytes.  See ``docs/serving.md``.
"""
from .batching import ContinuousBatcher, Request
from .kv_cache import (
    KVBytesModel,
    KVPageTable,
    PageSpec,
    ResizeResult,
    page_bytes_for_arch,
)
from .service import (
    EXECUTORS,
    ServeConfig,
    ServePhase,
    ServeReport,
    check_serve_agreement,
    run_serve,
    serve_config,
    serve_parity_key,
)

__all__ = [
    "ContinuousBatcher",
    "Request",
    "KVBytesModel",
    "KVPageTable",
    "PageSpec",
    "ResizeResult",
    "page_bytes_for_arch",
    "EXECUTORS",
    "ServeConfig",
    "ServePhase",
    "ServeReport",
    "check_serve_agreement",
    "run_serve",
    "serve_config",
    "serve_parity_key",
]
