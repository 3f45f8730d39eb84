"""Record-level telemetry next to the span tracer: the launch ledger."""
