"""Execution-layer interface: the port has the two names block import
reads on a failed or engine-checked transition; the engine API, the
ExecutionLayer facade, its transports and the mock engine wait (ROADMAP
Queue 1 item 14.8)."""

from .execution_layer import PayloadInvalid, PayloadVerificationStatus  # noqa: F401
