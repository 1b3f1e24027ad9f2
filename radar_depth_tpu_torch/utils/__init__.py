"""Host-side helpers of the training harness: CSV logs, run lock, stall
watchdog, comparison panels and optional TensorBoard scalars."""
