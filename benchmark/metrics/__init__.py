"""Per-layer metric readers, one file a metric, found by the metric's name.
Each defines read(measured) -> value, or None where it finds nothing to
read. `measured` holds the run's train_steps_per_s and setup_s, the
analytic flops_per_step (flops.py), the card's peak_flops and the traced
window's summary under "trace" (harness.summarize_trace)."""
