"""Host-side helpers of the runner: logging, meters, visualization,
TensorBoard writing and crash reports."""
