"""One reader per per-layer metric: ``read(ctx)`` returns the metric's
value from a traced run's ``tracing.Context``, or None where there is
nothing to read. A reader names what it needs: ``SPANS`` (engine calls
timed with the card synchronized) and ``RANGES`` (module attributes
whose calls' device time the profiler reads)."""
