"""Host-side helpers of the port (port of benor_tpu/utils/)."""
